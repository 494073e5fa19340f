"""Visibility buffer → dense per-pixel fragment inputs.

Given the raster output {tri_id, λ1, λ2} this reconstructs the interpolated
vertex varyings per pixel — the equivalent of the hardware interpolators
feeding ``fs_main``.

Per-pixel work is one row gather.  The per-triangle record packs
everything pixel shading needs that is constant per triangle:

  [v0 varyings (17) | v1 (17) | v2 (17) | mat_id | tex_w | tex_h |
   blk_base_hi | blk_base_lo | blk_w]

including the material's texture parameters (so the samplers need no
additional per-pixel parameter gathers; the row base is split into two
f32-exact halves).  Records are built per TRIANGLE, either with row
gathers of per-vertex varyings or, on the corner-major path, from the
corner planes directly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from kanirenderer_tpu.ops.raster_xla import VisBuffer

Array = jnp.ndarray

USED = 17  # varying channels 17..NV are padding (see ops/vertex.py layout)


class PixelBuffer(NamedTuple):
    varyings: Array  # (USED, H, W) interpolated vertex outputs, planar
    mat_id: Array    # (H, W) i32
    tex_w: Array     # (H, W) i32  material texture width
    tex_h: Array     # (H, W) i32
    blk_base: Array  # (H, W) i32  first block row of the material texture
    blk_w: Array     # (H, W) i32  blocks per texture row (ceil(w/6))
    mask: Array      # (H, W) bool — True where geometry covers the pixel
    z: Array         # (H, W) f32 depth
    overflow: Array = jnp.zeros((), jnp.int32)  # () i32 — chunks DROPPED
    #   by binning capacity (tile backend; 0 = complete geometry).
    #   Surfaced through FrameOutputs so the host loop can warn.


def build_tri_records(tri_idx: Array, tri_mat: Array, varyings: Array,
                      mat_blk_base: Array, mat_blk_w: Array,
                      mat_tex_size: Array, extra: Array = None) -> Array:
    """(T, 3·USED+6) per-triangle shading records from per-vertex
    varyings.

    ``extra``: precomputed static material-param lanes (Scene.tri_extra,
    planar (6, T)); material assignment is static per scene, so passing
    it skips 4 × T per-frame row gathers.  None/(0, 6) = compute here.
    """
    v = varyings[:, :USED]
    r0 = v[tri_idx[:, 0]]
    r1 = v[tri_idx[:, 1]]
    r2 = v[tri_idx[:, 2]]
    if extra is not None and extra.shape[0] == 6:
        extra = extra.T
    if extra is None or extra.shape[0] == 0:
        tw = jnp.take(mat_tex_size[:, 0], tri_mat, axis=0)
        th = jnp.take(mat_tex_size[:, 1], tri_mat, axis=0)
        base = jnp.take(mat_blk_base, tri_mat, axis=0)
        bw = jnp.take(mat_blk_w, tri_mat, axis=0)
        base_hi = base // 65536
        base_lo = base - base_hi * 65536
        extra = jnp.stack([tri_mat, tw, th, base_hi, base_lo, bw],
                          axis=1).astype(jnp.float32)
    return jnp.concatenate([r0, r1, r2, extra], axis=1)


def build_tri_records_corners(varyings_c, tri_extra: Array) -> Array:
    """The same (T, 3·USED+6) records from corner-major planes.

    ``varyings_c``: 3 corners × USED (T,) planes (CornerOutputs.varyings);
    ``tri_extra``: planar (6, T) static material lanes (Scene.tri_extra).
    No gathers: the corners were expanded at scene build.
    """
    cols = [p for k in range(3) for p in varyings_c[k][:USED]]
    cols.extend(tri_extra[i] for i in range(6))
    return jnp.stack(cols, axis=1)


def interpolate(vis: VisBuffer, tri_idx: Array, tri_mat: Array,
                varyings: Array, mat_blk_base: Array, mat_blk_w: Array,
                mat_tex_size: Array) -> PixelBuffer:
    """``interpolate_records`` with records built from per-vertex
    varyings."""
    return interpolate_records(vis, build_tri_records(
        tri_idx, tri_mat, varyings, mat_blk_base, mat_blk_w, mat_tex_size))


def interpolate_records(vis: VisBuffer, records: Array) -> PixelBuffer:
    """Per-pixel varyings and material parameters of each pixel's winning
    triangle (``records`` from ``build_tri_records*``)."""
    tid = jnp.maximum(vis.tri, 0)
    rec = jnp.take(records, tid, axis=0)        # (H, W, 3·USED+6)
    l1 = vis.bary[..., 0]
    l2 = vis.bary[..., 1]
    planes = []
    for c in range(USED):
        v0 = rec[..., c]
        v1 = rec[..., USED + c]
        v2 = rec[..., 2 * USED + c]
        planes.append(v0 + (v1 - v0) * l1 + (v2 - v0) * l2)
    planar = jnp.stack(planes)                  # (USED, H, W)
    k = 3 * USED
    # Combine the hi/lo halves in int32 — an f32 sum would lose exactness
    # once the block table exceeds 2^24 rows (very large texture sets).
    base = (rec[..., k + 3].astype(jnp.int32) * 65536
            + rec[..., k + 4].astype(jnp.int32))
    return PixelBuffer(varyings=planar,
                       mat_id=rec[..., k].astype(jnp.int32),
                       tex_w=rec[..., k + 1].astype(jnp.int32),
                       tex_h=rec[..., k + 2].astype(jnp.int32),
                       blk_base=base,
                       blk_w=rec[..., k + 5].astype(jnp.int32),
                       mask=vis.tri >= 0, z=vis.z, overflow=vis.overflow)
