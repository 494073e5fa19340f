"""Binned tile rasterizer for the GPU: a Pallas kernel on the Triton route.

The hot kernel of the renderer.  It replaces the wgpu fixed-function
rasterizer and depth test (reference render passes, src/lib.rs:1721-1862)
with a visibility-buffer tile loop:

* grid = (tiles_y, tiles_x): one program per (tile_h × tile_w) screen tile
  (powers of two), so a 1080p frame launches thousands of independent
  programs;
* each program reads its own (first entry, count) from the binner's
  header (ops/binning.StreamBins) and walks its chunks in the flat sorted
  stream; per chunk it visits only the subbatches whose overlap bit is
  set, and per triangle it loads the 12 edge/depth coefficients of its
  setup row (ops/vertex.py) as scalars and evaluates them over the tile;
* the accumulators (z, triangle id, l0, l1, l2) are loop carries that stay
  in registers; the program writes its output block once at the end.

Semantics are those of the brute-force oracle (ops/raster_xla.py): the
same plane expressions, coverage ``l_i ≥ 0 ∧ 0 ≤ z ≤ 1``, depth test
Less against a buffer cleared to 1.0, and triangles visited in increasing
id with a strict compare, so equal depths keep the lowest id.

``config.interpret`` runs the same kernel through the Pallas interpreter
(the CPU tests); it is never chosen from the device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from kanirenderer_tpu.core.types import (CHUNK_SIZE, SUBBATCH,
                                         SUBS_PER_CHUNK, RenderConfig)
from kanirenderer_tpu.ops import binning
from kanirenderer_tpu.ops.raster_xla import VisBuffer
from kanirenderer_tpu.ops.vertex import TriangleSetup

Array = jnp.ndarray

# Triton launch parameters (chosen by the tile sweep in
# scripts/sweep_tiles.py; PERF.md records it).
NUM_WARPS = 4
NUM_STAGES = 1


def _tile_kernel(hdr_ref, stream_ref, setup_ref, *out_refs, tile_h, tile_w,
                 tiles_x, y_stride, depth_only, wireframe, wire_thresh):
    i = pl.program_id(0)
    j = pl.program_id(1)
    tile = i * tiles_x + j
    first = hdr_ref[0, tile]
    count = hdr_ref[1, tile]

    shape = (tile_h, tile_w)
    xs = (j * tile_w).astype(jnp.float32) + 0.5 + jax.lax.broadcasted_iota(
        jnp.int32, shape, 1).astype(jnp.float32)
    # Interleaved bands (y_stride > 1): band tile row i is global tile row
    # i·y_stride + k; the k·tile_h offset is folded into the plane
    # constants by the caller.
    ys = (i * (tile_h * y_stride)).astype(jnp.float32) + 0.5 \
        + jax.lax.broadcasted_iota(jnp.int32, shape, 0).astype(jnp.float32)

    def plane(row, c):
        return (setup_ref[row, c] * xs + setup_ref[row, c + 1] * ys) \
            + setup_ref[row, c + 2]

    def triangle(row, carry):
        l0, l1, l2, z = (plane(row, c) for c in (0, 3, 6, 9))
        cov = (l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0) & (z >= 0.0) \
            & (z <= 1.0)
        if wireframe:
            def dist(l, c):
                a, b = setup_ref[row, c], setup_ref[row, c + 1]
                return l / jnp.maximum(jnp.sqrt(a * a + b * b), 1e-20)
            d = jnp.minimum(jnp.minimum(dist(l0, 0), dist(l1, 3)),
                            dist(l2, 6))
            cov = cov & (d <= wire_thresh)
        if depth_only:
            (zb,) = carry
            return (jnp.minimum(zb, jnp.where(cov, z, 1.0)),)
        zb, tri, w0, w1, w2 = carry
        hit = cov & (z < zb)
        return (jnp.where(hit, z, zb), jnp.where(hit, row, tri),
                jnp.where(hit, l0, w0), jnp.where(hit, l1, w1),
                jnp.where(hit, l2, w2))

    def chunk_entry(e, carry):
        cid = stream_ref[first + e, 0]
        mask = stream_ref[first + e, 1]

        def subbatch(s, carry):
            base = cid * CHUNK_SIZE + s * SUBBATCH

            def run(carry):
                return jax.lax.fori_loop(
                    0, SUBBATCH, lambda k, c: triangle(base + k, c), carry)

            return jax.lax.cond(((mask >> s) & 1) != 0, run, lambda c: c,
                                carry)

        return jax.lax.fori_loop(0, SUBS_PER_CHUNK, subbatch, carry)

    ones = jnp.ones(shape, jnp.float32)
    if depth_only:
        init = (ones,)
    else:
        zero = jnp.zeros(shape, jnp.float32)
        init = (ones, jnp.full(shape, -1, jnp.int32), zero, zero, zero)
    out = jax.lax.fori_loop(0, count, chunk_entry, init)

    if depth_only:
        out_refs[0][...] = out[0]
        return
    zb, tri, w0, w1, w2 = out
    z_ref, tri_ref, b1_ref, b2_ref = out_refs
    lsum = w0 + w1 + w2
    lsum = jnp.where(lsum != 0.0, lsum, 1e-30)
    z_ref[...] = zb
    tri_ref[...] = tri
    b1_ref[...] = w1 / lsum
    b2_ref[...] = w2 / lsum


def raster_call(setup: Array, bins: binning.StreamBins, tiles_x: int,
                tiles_y: int, tile_w: int, tile_h: int, *, depth_only: bool,
                wireframe: bool = False, wire_thresh: float = 0.0,
                y_stride: int = 1, interpret: bool = False,
                num_warps: int = NUM_WARPS,
                num_stages: int = NUM_STAGES) -> list:
    """One launch over a (tiles_y, tiles_x) grid.  Returns the padded
    (tiles_y·tile_h, tiles_x·tile_w) planes: [z] for ``depth_only``, else
    [z, tri, λ1, λ2]."""
    for n in (tile_h, tile_w):
        if n & (n - 1):
            raise ValueError(f"tile sides must be powers of two, got {n}")
    kernel = functools.partial(
        _tile_kernel, tile_h=tile_h, tile_w=tile_w, tiles_x=tiles_x,
        y_stride=y_stride, depth_only=depth_only, wireframe=wireframe,
        wire_thresh=wire_thresh)
    ph, pw = tiles_y * tile_h, tiles_x * tile_w
    dtypes = ([jnp.float32] if depth_only
              else [jnp.float32, jnp.int32, jnp.float32, jnp.float32])
    block = pl.BlockSpec((tile_h, tile_w), lambda i, j: (i, j))
    return pl.pallas_call(
        kernel,
        grid=(tiles_y, tiles_x),
        in_specs=[pl.no_block_spec] * 3,
        out_specs=[block] * len(dtypes),
        out_shape=[jax.ShapeDtypeStruct((ph, pw), d) for d in dtypes],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=num_stages),
        interpret=interpret,
        name="tile_depth" if depth_only else "tile_raster",
    )(bins.header, bins.stream, setup)


def _reanchor(setup: Array, y0) -> Array:
    """Shift every plane's origin to screen row ``y0`` (c ← c + b·y0), so a
    band renders rows [y0, y0 + band_h) as rows [0, band_h)."""
    cols = jnp.array([2, 5, 8, 11])
    return setup.at[:, cols].add(setup[:, cols - 1] * y0)


def _slice_bins(bins: binning.StreamBins, tiles_band: int, y_stride: int,
                tiles_x: int, k) -> binning.StreamBins:
    """Interleaved-band view of full-grid binning: keep the shared stream,
    take the header columns of global tile rows r with r % y_stride == k
    (band tile row r // y_stride).  ``k`` may be traced."""
    hdr = bins.header.reshape(2, tiles_band, y_stride, tiles_x)
    hdr = jax.lax.dynamic_index_in_dim(hdr, k, axis=2, keepdims=False)
    return bins._replace(header=hdr.reshape(2, tiles_band * tiles_x))


@functools.partial(jax.jit, static_argnames=("config", "wireframe", "band_h",
                                             "y_stride"))
def rasterize(st: TriangleSetup, config: RenderConfig,
              wireframe: bool = False, band_h: int | None = None,
              y0: Array | None = None, y_stride: int = 1) -> VisBuffer:
    """Visibility buffer of ``config.width`` × ``band_h`` pixels.

    ``band_h``/``y0``: render only screen rows [y0, y0 + band_h) — the
    row-band sharding path (parallel/mesh.py).  ``y0`` may be traced (it
    derives from ``lax.axis_index``): the planes are re-anchored and the
    bboxes shifted, so the kernel always rasterizes rows [0, band_h).

    ``y_stride`` > 1: interleaved bands — the band is tile rows k,
    k + y_stride, … of the full frame (k = y0 / tile_h), so content skew
    spreads evenly over the devices.  Binning runs on the full grid and
    each band takes its header columns; band_h must be a multiple of
    tile_h."""
    cfg = config
    setup, bbox = st.setup, st.bbox
    if band_h is None:
        band_h = cfg.height
    if y_stride > 1 and (y0 is None or band_h % cfg.tile_h):
        raise ValueError("interleaved bands need y0 and a tile-aligned band")
    if y0 is not None:
        y0f = jnp.asarray(y0, jnp.float32)
        setup = _reanchor(setup, y0f)
        if y_stride == 1:
            bbox = bbox.at[:, jnp.array([1, 3])].add(-y0f)
    tiles_y = -(-band_h // cfg.tile_h)
    bins = binning.bin_stream(bbox, cfg.tiles_x, tiles_y * y_stride,
                              cfg.tile_w, cfg.tile_h,
                              cfg.max_tiles_per_chunk, cfg.max_global_chunks)
    if y_stride > 1:
        k = jnp.round(y0f / cfg.tile_h).astype(jnp.int32)
        bins = _slice_bins(bins, tiles_y, y_stride, cfg.tiles_x, k)
    z, tri, b1, b2 = raster_call(
        setup, bins, cfg.tiles_x, tiles_y, cfg.tile_w, cfg.tile_h,
        depth_only=False, wireframe=wireframe,
        wire_thresh=cfg.wire_thresh_px, y_stride=y_stride,
        interpret=cfg.interpret)
    H, W = band_h, cfg.width
    return VisBuffer(tri=tri[:H, :W], z=z[:H, :W],
                     bary=jnp.stack([b1[:H, :W], b2[:H, :W]], axis=-1),
                     overflow=bins.overflow)


def shadow_bins(st: TriangleSetup, config: RenderConfig,
                band_h: int | None = None) -> binning.StreamBins:
    """Binning of a light-space setup over the shadow map's tile grid."""
    cfg = config
    rows = cfg.shadow_dim if band_h is None else band_h
    return binning.bin_stream(
        st.bbox, -(-cfg.shadow_dim // cfg.tile_w),
        -(-rows // cfg.shadow_tile_h), cfg.tile_w, cfg.shadow_tile_h,
        cfg.max_tiles_per_chunk, cfg.max_global_chunks)


@functools.partial(jax.jit, static_argnames=("config", "band_h"))
def rasterize_depth(st: TriangleSetup, config: RenderConfig,
                    band_h: int | None = None, y0=None,
                    bins: binning.StreamBins | None = None) -> Array:
    """Depth-only shadow-map raster over the shadow_dim square
    (reference src/lib.rs:1721-1751: Depth32Float cleared to 1.0).

    ``band_h``/``y0`` restrict output to map rows [y0, y0 + band_h) for
    the sharded shadow pass, with the same re-anchoring as
    ``rasterize``.  ``bins``: optional precomputed ``shadow_bins(st)``
    (full map only)."""
    cfg = config
    dim = cfg.shadow_dim
    H = dim if band_h is None else band_h
    if y0 is not None:
        if bins is not None:
            raise ValueError("precomputed bins are full-map only")
        y0f = jnp.asarray(y0, jnp.float32)
        st = st._replace(setup=_reanchor(st.setup, y0f),
                         bbox=st.bbox.at[:, jnp.array([1, 3])].add(-y0f))
    if bins is None:
        bins = shadow_bins(st, cfg, band_h)
    (z,) = raster_call(st.setup, bins, -(-dim // cfg.tile_w),
                       -(-H // cfg.shadow_tile_h), cfg.tile_w,
                       cfg.shadow_tile_h, depth_only=True,
                       interpret=cfg.interpret)
    return z[:H, :dim]
