"""Gather-based texture sampling — one row gather per sampled surface.

Every sampler here is built as ONE wide row gather per pixel followed by
lane-space multiply-reduce math (never a transpose of the gathered
array):

* ``sample_materials_blocks`` — diffuse + normal-map bilinear filtering
  with Repeat addressing from per-texture block-window tables
  (core/types.Scene.tex_diffuse/tex_normal, bf16): each texture is tiled
  into 6×4-texel blocks whose Repeat-wrapped 7×5 windows (35 texels ×
  RGB = 105 lanes) form one 128-lane row, so a pixel's whole 2×2
  bilinear footprint lives in one gathered row per texture, and the
  tables carry ~1.46 lanes/texel instead of the 2×2-row layout's 4.
  Filtering applies separable bilinear weights as a lane mask, then one
  matmul against a constant (128, 3) channel selector reduces all three
  channels in a single pass.  Matches the material sampler state
  (reference src/texture.rs:162-173).
* ``build_shadow_table`` / ``sample_shadow_pcf`` — the 3×3 PCF kernel of
  comparison taps (reference src/lib.rs:760-767, src/shader.wgsl:140-159)
  from an 8×8-block window table: row b = the clamp-padded 11×11 texel
  window of shadow block b, so a pixel's whole 4×4 PCF footprint lives in
  one gathered row.  Tap extraction needs no per-pixel gather because the
  nine bilinear taps have separable weights:
      PCF = (1/9) · wyᵀ C wx,  wy = [1-fy, 1, 1, fy] (same for x),
  which becomes a weighted lane reduction over the window.  Clamp-to-edge
  addressing (wgpu sampler default).  f32 — bit-identical to per-tap math.
"""

from __future__ import annotations

import numpy as np

import jax

import jax.numpy as jnp

Array = jnp.ndarray

# Shadow block-window geometry: 8×8 texel blocks, 11×11 window (one texel
# apron left/top for the PCF -1 offset, two right/bottom for +2).
# The 121..127 zero-padding lanes carry a far-outside column coordinate so
# the trapezoid weight (sample_shadow_pcf) is exactly 0 there — no separate
# validity mask needed.
_B = 8
_WIN = _B + 3
_LANE_ROW = jnp.asarray(np.arange(128) // _WIN, jnp.float32)
_LANE_COL = jnp.asarray(np.where(np.arange(128) < _WIN * _WIN,
                                 np.arange(128) % _WIN, -100.0), jnp.float32)


# Material block-window geometry: 6×4-texel blocks, Repeat-wrapped 7×5
# window × RGB = 105 lanes (one apron column/row for the +1 bilinear
# neighbor; wrap is baked into the window at build time).
MAT_BX = 6
MAT_BY = 4
MAT_WINX = MAT_BX + 1
MAT_WINY = MAT_BY + 1
MAT_LANES = MAT_WINX * MAT_WINY * 3
_MLANE = np.minimum(np.arange(128), MAT_LANES - 1)
_MLANE_ROW = jnp.asarray(_MLANE // (MAT_WINX * 3), jnp.float32)
_MLANE_COL = jnp.asarray((_MLANE // 3) % MAT_WINX, jnp.float32)
# Per-channel lane-selector matrix (zero on the >MAT_LANES padding lanes).
_MCH_T = jnp.asarray(
    np.stack([(np.arange(128) % 3 == c) & (np.arange(128) < MAT_LANES)
              for c in range(3)], axis=1), np.float32)  # (128, 3)


# Combined-table geometry: 3×4-texel blocks, 4×5 window × 6 channels
# (diffuse RGB + normal RGB interleaved per texel) = 120 lanes — ONE row
# gather yields a pixel's whole bilinear footprint for BOTH textures,
# halving the per-pixel gather count vs the separate 6×4 tables.  u8
# only (sqrt-encoded diffuse + raw unorm normals); scenes with
# higher-depth normal maps keep the separate-table path for fidelity
# (reference src/texture.rs:113-129).
CMB_BX = 3
CMB_BY = 4
CMB_WINX = CMB_BX + 1
CMB_WINY = CMB_BY + 1
CMB_LANES = CMB_WINX * CMB_WINY * 6    # 120
_CLANE = np.minimum(np.arange(128), CMB_LANES - 1)
_CLANE_ROW = jnp.asarray(_CLANE // (CMB_WINX * 6), jnp.float32)
_CLANE_COL = jnp.asarray((_CLANE // 6) % CMB_WINX, jnp.float32)
_CLANE_OK = np.arange(128) < CMB_LANES
# per-lane decode scale: diffuse lanes hold round(sqrt(linear)·255)
# (decode v²/65025), normal lanes raw u8 unorm (decode v/255)
_C_DSCALE = jnp.asarray(np.where(_CLANE_OK & (np.arange(128) % 6 < 3),
                                 1.0 / 65025.0, 0.0), jnp.float32)
_C_NSCALE = jnp.asarray(np.where(_CLANE_OK & (np.arange(128) % 6 >= 3),
                                 1.0 / 255.0, 0.0), jnp.float32)
# (128, 6) channel selector: column c sums the lanes of channel c
_C_SEL = jnp.asarray(
    np.stack([(np.arange(128) % 6 == c) & _CLANE_OK for c in range(6)],
             axis=1), np.float32)


def build_combined_blocks(diffuse_u8: "np.ndarray",
                          normal_u8: "np.ndarray") -> "np.ndarray":
    """(h, w, 3) u8 sqrt-encoded diffuse + (h, w, 3) u8 raw normal →
    (ceil(h/4)·ceil(w/3), 128) u8 combined block rows (Repeat-wrapped
    4×5 windows, lanes (row, col, drgb+nrgb) channel-innermost).
    Host-side numpy; runs once per texture at scene pack."""
    h, w = diffuse_u8.shape[:2]
    bw = -(-w // CMB_BX)
    bh = -(-h // CMB_BY)
    ys = (np.arange(bh)[:, None] * CMB_BY + np.arange(CMB_WINY)[None]) % h
    xs = (np.arange(bw)[:, None] * CMB_BX + np.arange(CMB_WINX)[None]) % w
    both = np.concatenate([diffuse_u8, normal_u8], axis=-1)   # (h, w, 6)
    win = both[ys[:, None, :, None], xs[None, :, None, :]]    # (bh,bw,5,4,6)
    rows = win.reshape(bh * bw, CMB_LANES)
    return np.pad(rows, ((0, 0), (0, 128 - CMB_LANES)))


def sample_materials_combined(tex_combined: Array, blk_base: Array,
                              blk_w: Array, tw: Array, th: Array,
                              u: Array, v: Array) -> tuple[Array, Array]:
    """Single-gather variant of ``sample_materials_blocks``: one row
    gather from the combined table + one (128, 6) selector matmul
    produces both the diffuse and the normal sample."""
    tx = u * tw.astype(jnp.float32) - 0.5
    ty = v * th.astype(jnp.float32) - 0.5
    x0 = jnp.floor(tx)
    y0 = jnp.floor(ty)
    fx = tx - x0
    fy = ty - y0
    x0i = jnp.mod(x0.astype(jnp.int32), tw)
    y0i = jnp.mod(y0.astype(jnp.int32), th)
    bx = x0i // CMB_BX
    by = y0i // CMB_BY
    lx = x0i - bx * CMB_BX
    ly = y0i - by * CMB_BY
    row = blk_base + by * blk_w + bx

    # Bilinear weights as hat functions of the lane's texel distance from
    # the in-window sample position (ax, ay): max(0, 1 − |lane − a|) hits
    # 1−f at the anchor texel and f at its +1 neighbor — 5 ops per axis
    # instead of the 7 of the compare/select form.
    ax = (lx.astype(jnp.float32) + fx)[..., None]
    ay = (ly.astype(jnp.float32) + fy)[..., None]
    wx = jnp.maximum(1.0 - jnp.abs(_CLANE_COL[None, None, :] - ax), 0.0)
    wy = jnp.maximum(1.0 - jnp.abs(_CLANE_ROW[None, None, :] - ay), 0.0)
    wgt = wx * wy

    win = jnp.take(tex_combined, row, axis=0)             # (H, W, 128)
    w32 = win.astype(jnp.float32)
    s = (w32 * _C_DSCALE + _C_NSCALE) * w32 * wgt
    out6 = jax.lax.dot_general(
        s.reshape(-1, 128), _C_SEL,
        (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)              # (H·W, 6)
    out6 = out6.reshape(u.shape + (6,))
    return (jnp.moveaxis(out6[..., :3], -1, 0),
            jnp.moveaxis(out6[..., 3:], -1, 0))


def build_material_blocks(tex: "np.ndarray") -> "np.ndarray":
    """(h, w, 3) texture (any dtype) → (ceil(h/4)·ceil(w/6), 128) block rows.

    Row (by·bw + bx) holds the 7×5 window of block (by, bx) with Repeat
    (modulo) addressing baked in, lanes ordered (row, col, channel)
    innermost-channel to match the sampler's channel-selector matmul.
    Dtype-preserving (u8 sqrt-encoded diffuse, u8/u16/f32 raw normals —
    see io/scene_loader table packing).  Host-side numpy; runs once per
    texture at scene pack."""
    h, w = tex.shape[:2]
    bw = -(-w // MAT_BX)
    bh = -(-h // MAT_BY)
    ys = (np.arange(bh)[:, None] * MAT_BY + np.arange(MAT_WINY)[None]) % h
    xs = (np.arange(bw)[:, None] * MAT_BX + np.arange(MAT_WINX)[None]) % w
    win = tex[ys[:, None, :, None], xs[None, :, None, :]]  # (bh,bw,5,7,3)
    rows = win.reshape(bh * bw, MAT_LANES)
    return np.pad(rows, ((0, 0), (0, 128 - MAT_LANES)))


def sample_materials_blocks(tex_diffuse: Array, tex_normal: Array,
                            blk_base: Array, blk_w: Array, tw: Array,
                            th: Array, u: Array,
                            v: Array) -> tuple[Array, Array]:
    """Returns (diffuse (3,H,W) linear f32, normal (3,H,W) raw f32).

    blk_base/blk_w/tw/th are per-pixel (H, W) i32 planes taken from the
    triangle records — no per-pixel parameter gathers happen here.  One
    row gather per texture; the separable bilinear weights become a lane
    mask and one channel-selector matmul reduces RGB in a single pass, so
    the gathers stay on the fast path (no transpose consumer, no
    duplicated reductions); accumulation is f32 regardless of the table
    dtype (bf16 in the packed Scene)."""
    tx = u * tw.astype(jnp.float32) - 0.5
    ty = v * th.astype(jnp.float32) - 0.5
    x0 = jnp.floor(tx)
    y0 = jnp.floor(ty)
    fx = tx - x0
    fy = ty - y0
    x0i = jnp.mod(x0.astype(jnp.int32), tw)
    y0i = jnp.mod(y0.astype(jnp.int32), th)
    bx = x0i // MAT_BX
    by = y0i // MAT_BY
    lx = x0i - bx * MAT_BX
    ly = y0i - by * MAT_BY
    row = blk_base + by * blk_w + bx

    # Hat-function bilinear weights (see sample_materials_combined).
    ax = (lx.astype(jnp.float32) + fx)[..., None]
    ay = (ly.astype(jnp.float32) + fy)[..., None]
    wx = jnp.maximum(1.0 - jnp.abs(_MLANE_COL[None, None, :] - ax), 0.0)
    wy = jnp.maximum(1.0 - jnp.abs(_MLANE_ROW[None, None, :] - ay), 0.0)
    wgt = wx * wy

    def tex(tbl, sqrt_encoded):
        """Gather + per-texel decode + weighted channel reduction.

        Table dtype drives the decode (quantized tables halve the gather
        footprint — the row-gather fast path needs small tables):
        * uint8 + sqrt_encoded — diffuse stores round(sqrt(linear)·255);
          decode = v²/65025 (texel-exact square, no transcendental), same
          ~0.4% precision as bf16 at half the bytes;
        * uint8 / uint16 raw — normal maps at exact source depth
          (reference texture.rs:113-129 picks the format by source type);
          the 1/255 or 1/65535 scale folds into the bilinear weights;
        * float (f32/bf16) — raw linear values (tests, float sources).
        """
        win = jnp.take(tbl, row, axis=0)              # (H, W, 128)
        w32 = win.astype(jnp.float32)
        if tbl.dtype == jnp.uint8 and sqrt_encoded:
            s = (w32 * w32) * (wgt * (1.0 / 65025.0))
        elif tbl.dtype == jnp.uint8:
            s = w32 * (wgt * (1.0 / 255.0))
        elif tbl.dtype == jnp.uint16:
            s = w32 * (wgt * (1.0 / 65535.0))
        else:
            s = w32 * wgt
        # One matmul against the constant (128, 3) channel-selector does
        # all three per-channel lane reductions in a single pass over the
        # gathered data (per-channel masked .sum(-1) reductions made XLA
        # duplicate the gather per consumer — 3× the traffic).
        rgb = jax.lax.dot_general(
            s.reshape(-1, 128), _MCH_T,
            (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)      # (H·W, 3)
        return jnp.moveaxis(rgb.reshape(u.shape + (3,)), -1, 0)

    return tex(tex_diffuse, True), tex(tex_normal, False)


def build_shadow_table(shadow_map: Array) -> Array:
    """(D, D) shadow map → ((D/8)², 128) u16 block-window table.

    Row (by·NB + bx) holds the clamp-padded 11×11 window anchored at
    texel (8bx−1, 8by−1), flattened row-major into lanes 0..120 (lanes
    121..127 are zero padding).  Built purely from reshapes and
    concatenations of aligned slices (no strided slices).

    Depth is quantized to 16-bit unorm (a classic D16 shadow buffer):
    the table halves to 16.8 MB at 2048²; the ≤½-quantum (7.6e-6) comparison shift is
    orders of magnitude below the shadow depth bias."""
    D = shadow_map.shape[0]
    assert D % _B == 0, "shadow_dim must be a multiple of 8"
    q = jnp.round(jnp.clip(shadow_map, 0.0, 1.0) * 65535.0) \
        .astype(jnp.uint16)
    padded = jnp.pad(q, ((1, _B), (1, _B)), mode="edge")
    return _table_from_padded_rows(padded[:D + 3], D)


def _table_from_padded_rows(P: Array, D: int) -> Array:
    """Block-window table rows from PADDED map rows.

    ``P``: (8·nbb + 3, D + 9) u16 — the (edge/halo-)padded rows covering
    a contiguous band of nbb block rows (the full map is the nbb = D/8
    case; the sharded fresh-shadow path builds each chip's band from its
    raster band + a 1-above/2-below ppermute halo and all_gathers the
    TABLE instead of the map — parallel/mesh.py, r5)."""
    W = D + _B + 1
    nb = D // _B
    nbb = (P.shape[0] - 3) // _B
    # rows: aligned 8-row groups + the next group's first 3 rows
    top8 = P[:_B * nbb].reshape(nbb, _B, W)
    nxt = P[_B:]
    nxt3 = jnp.pad(nxt, ((0, _B * nbb - nxt.shape[0]), (0, 0))) \
        .reshape(nbb, _B, W)[:, :3]
    w1 = jnp.concatenate([top8, nxt3], axis=1)             # (nbb, 11, W-?)
    # columns: same split along x
    c = w1[:, :, :D + _B].reshape(nbb, _WIN, nb + 1, _B)
    w2 = jnp.concatenate([c[:, :, :-1], c[:, :, 1:, :3]], axis=3)
    t = w2.transpose(0, 2, 1, 3).reshape(nbb * nb, _WIN * _WIN)
    return jnp.pad(t, ((0, 0), (0, 128 - _WIN * _WIN)))


def build_shadow_table_band(band: Array, top1: Array, bot2: Array,
                            D: int) -> Array:
    """This chip's table rows from its shadow-map ROW BAND + halo rows.

    ``band``: (sb_h, D) f32 raster band (map rows [k·sb_h, (k+1)·sb_h));
    ``top1``: (1, D) the map row just above (edge-clamped at k = 0);
    ``bot2``: (2, D) the two map rows just below (edge-clamped at the
    last chip).  Exactly build_shadow_table's rows for this band: block
    row by needs map rows [8·by − 1, 8·by + 10], so a band needs 1 halo
    row above and 2 below.  Returns (sb_h/8 · D/8, 128); an all_gather
    over the band axis reassembles the full table."""
    rows = jnp.concatenate([top1, band, bot2], axis=0)     # (sb_h+3, D)
    q = jnp.round(jnp.clip(rows, 0.0, 1.0) * 65535.0).astype(jnp.uint16)
    P = jnp.pad(q, ((0, 0), (1, _B)), mode="edge")
    return _table_from_padded_rows(P, D)


def sample_shadow_pcf(shadow_table: Array, dim: int, u: Array, v: Array,
                      depth: Array) -> Array:
    """3×3 PCF average of hardware-style comparison taps — one block-row
    gather + a separable-weight lane reduction (see module docstring)."""
    D = dim
    nb = D // _B
    tx = u * D - 0.5
    ty = v * D - 0.5
    x0 = jnp.floor(tx)
    y0 = jnp.floor(ty)
    fx = tx - x0
    fy = ty - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, D - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, D - 1)
    blk = (y0i >> 3) * nb + (x0i >> 3)
    ly = y0i & (_B - 1)
    lx = x0i & (_B - 1)

    win = jnp.take(shadow_table, blk, axis=0)            # (H, W, 128)
    # u16-unorm depth compare (quantized like build_shadow_table); float
    # tables (tests) compare raw.
    if shadow_table.dtype == jnp.uint16:
        dq = depth[..., None] * 65535.0
    else:
        dq = depth[..., None]
    passed = dq <= win.astype(jnp.float32)

    # Separable footprint weights over window lanes: a tap at window
    # offset (dy, dx) ∈ [0,4)² from the anchor (ly, lx) carries weight
    # wy[dy]·wx[dx] with wy = [1−fy, 1, 1, fy] — the row/col sums of the
    # nine bilinear kernels.  That profile is a trapezoid in the lane's
    # distance d = lane_row − (ly + fy): clamp(min(d+1, 3−d), 0, 1) hits
    # 1−fy, 1, 1, fy at d = −fy, 1−fy, 2−fy, 3−fy and 0 outside — 5 ops
    # per axis instead of the 8 of the compare/select formulation.
    ay = (ly.astype(jnp.float32) + fy)[..., None]
    ax = (lx.astype(jnp.float32) + fx)[..., None]
    dyv = _LANE_ROW[None, None, :] - ay
    dxv = _LANE_COL[None, None, :] - ax
    wy = jnp.clip(jnp.minimum(dyv + 1.0, 3.0 - dyv), 0.0, 1.0)
    wx = jnp.clip(jnp.minimum(dxv + 1.0, 3.0 - dxv), 0.0, 1.0)
    return jnp.where(passed, wy * wx, 0.0).sum(-1) / 9.0
