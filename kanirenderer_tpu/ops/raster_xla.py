"""Brute-force visibility-buffer rasterizer in pure XLA.

Correctness oracle for the tile kernel (ops/raster_tiles.py) and the
raster of the CPU backend.  Evaluates every triangle
against every pixel in fixed-size batches under ``lax.scan`` — O(T · H · W),
fine for cube-sized scenes and golden tests.

Together with ops/vertex.triangle_setup this replaces the wgpu fixed-function
rasterizer + depth test (reference render passes, src/lib.rs:1721-1862):
coverage via sign-normalized homogeneous edge functions, depth via the
z/w interpolation rows, depth compare Less against a z-buffer cleared to 1.0
(reference src/lib.rs:1729, 1773, 201-202).

The output is a *visibility buffer*: per pixel the winning triangle id, its
depth, and perspective-correct barycentrics (λ1, λ2).  Shading happens later
as a dense pass (shade/): the irregular raster work touches 4 small
channels, while all heavy material math runs once per visible pixel.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from kanirenderer_tpu.ops.vertex import TriangleSetup

Array = jnp.ndarray


class VisBuffer(NamedTuple):
    tri: Array   # (H, W) i32 triangle id, -1 = background
    z: Array     # (H, W) f32 depth in [0, 1], 1.0 = far/clear
    bary: Array  # (H, W, 2) f32 perspective-correct (λ1, λ2)
    overflow: Array = jnp.zeros((), jnp.int32)  # () i32 — chunks dropped
    #   by the tile binner's capacity (0 = complete geometry; the oracle
    #   drops nothing)


def _pixel_grid(width: int, height: int, y0=0.0, y_stride: int = 1,
                tile_h: int = 0) -> tuple[Array, Array]:
    xs = jnp.arange(width, dtype=jnp.float32) + 0.5
    r = jnp.arange(height, dtype=jnp.float32)
    if y_stride > 1:
        # Interleaved row bands (ops/raster_tiles interleaved mode):
        # band row block j = global tile row j·y_stride + k, with the
        # traced k·tile_h offset arriving via y0.
        r = (r // tile_h) * (y_stride * tile_h) + (r % tile_h)
    ys = r + 0.5 + y0
    return xs[None, :], ys[:, None]  # broadcastable (1, W), (H, 1)


@partial(jax.jit, static_argnames=("width", "height", "wireframe",
                                   "wire_thresh", "batch", "y_stride",
                                   "tile_h"))
def rasterize_xla(setup: Array, width: int, height: int,
                  wireframe: bool = False, wire_thresh: float = 0.7,
                  batch: int = 16, y_offset=0.0, y_stride: int = 1,
                  tile_h: int = 0) -> VisBuffer:
    """Rasterize all triangles (setup rows, see ops/vertex.py) brute-force.

    ``wireframe``: restrict coverage to pixels within ``wire_thresh`` pixels
    of a triangle edge — the PolygonMode::Line equivalent
    (reference src/lib.rs:254): interiors stay transparent, depth still
    tested, both faces drawn (culling is handled upstream in setup).
    """
    T = setup.shape[0]
    pad = (-T) % batch
    if pad:
        setup = jnp.concatenate(
            [setup, jnp.zeros((pad, setup.shape[1]), setup.dtype)])
    chunks = setup.reshape(-1, batch, setup.shape[1])

    X, Y = _pixel_grid(width, height, y_offset, y_stride, tile_h)

    def body(carry, args):
        zbuf, tri, b1, b2 = carry
        chunk, base = args  # (batch, 16), ()

        r = chunk[:, 0:9].reshape(batch, 3, 3)
        zrow = chunk[:, 9:12]
        vflag = chunk[:, 15] > 0.0

        # l_i(p): (batch, H, W)
        def lin(row):  # row: (batch, 3)
            return (row[:, 0, None, None] * X[None] +
                    row[:, 1, None, None] * Y[None] +
                    row[:, 2, None, None])

        l0 = lin(r[:, 0])
        l1 = lin(r[:, 1])
        l2 = lin(r[:, 2])
        z = lin(zrow)   # screen-affine NDC depth (ops/vertex.py col 9:12)

        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        covered = inside & (z >= 0.0) & (z <= 1.0) \
            & vflag[:, None, None]
        if wireframe:
            def edge_dist(l, row):
                g = jnp.sqrt(row[:, 0] ** 2 + row[:, 1] ** 2)
                return l / jnp.maximum(g, 1e-20)[:, None, None]
            d = jnp.minimum(jnp.minimum(edge_dist(l0, r[:, 0]),
                                        edge_dist(l1, r[:, 1])),
                            edge_dist(l2, r[:, 2]))
            covered = covered & (d <= wire_thresh)

        zc = jnp.where(covered, z, jnp.inf)
        best = jnp.argmin(zc, axis=0)                       # (H, W)
        bz = jnp.take_along_axis(zc, best[None], axis=0)[0]
        any_cov = jnp.isfinite(bz)

        lsum = l0 + l1 + l2
        lsum = jnp.where(lsum != 0, lsum, 1e-30)
        lb1 = jnp.take_along_axis(l1 / lsum, best[None], axis=0)[0]
        lb2 = jnp.take_along_axis(l2 / lsum, best[None], axis=0)[0]

        win = any_cov & (bz < zbuf)
        zbuf = jnp.where(win, bz, zbuf)
        tri = jnp.where(win, base + best.astype(jnp.int32), tri)
        b1 = jnp.where(win, lb1, b1)
        b2 = jnp.where(win, lb2, b2)
        return (zbuf, tri, b1, b2), None

    # fold y_offset into the init so that under shard_map the carry picks
    # up the same varying-axis type as the loop body (y_offset is the only
    # shard-varying input)
    y0f = jnp.asarray(y_offset, jnp.float32) * 0.0
    init = (jnp.ones((height, width), jnp.float32) + y0f,
            jnp.full((height, width), -1, jnp.int32) + y0f.astype(jnp.int32),
            jnp.zeros((height, width), jnp.float32) + y0f,
            jnp.zeros((height, width), jnp.float32) + y0f)
    bases = jnp.arange(chunks.shape[0], dtype=jnp.int32) * batch
    (zbuf, tri, b1, b2), _ = jax.lax.scan(body, init, (chunks, bases))
    return VisBuffer(tri=tri, z=zbuf, bary=jnp.stack([b1, b2], -1))


@partial(jax.jit, static_argnames=("dim", "batch", "band_h"))
def rasterize_depth_xla(setup: Array, dim: int, batch: int = 16,
                        band_h: int | None = None, y_offset=0.0) -> Array:
    """Depth-only square raster for the shadow pass (reference
    src/lib.rs:1721-1751: 2048² Depth32Float cleared to 1.0).

    ``band_h``/``y_offset`` restrict output to map rows
    [y_offset, y_offset+band_h) — the multi-chip sharded shadow pass
    (parallel/mesh.py)."""
    T = setup.shape[0]
    pad = (-T) % batch
    if pad:
        setup = jnp.concatenate(
            [setup, jnp.zeros((pad, setup.shape[1]), setup.dtype)])
    chunks = setup.reshape(-1, batch, setup.shape[1])
    X, Y = _pixel_grid(dim, dim if band_h is None else band_h, y_offset)

    def body(zbuf, chunk):
        r = chunk[:, 0:9].reshape(batch, 3, 3)

        def lin(row):
            return (row[:, 0, None, None] * X[None] +
                    row[:, 1, None, None] * Y[None] +
                    row[:, 2, None, None])

        l0, l1, l2 = lin(r[:, 0]), lin(r[:, 1]), lin(r[:, 2])
        z = lin(chunk[:, 9:12])   # screen-affine NDC depth
        covered = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) \
            & (z >= 0.0) & (z <= 1.0) & (chunk[:, 15] > 0)[:, None, None]
        zc = jnp.where(covered, z, jnp.inf).min(axis=0)
        return jnp.minimum(zbuf, jnp.where(jnp.isfinite(zc), zc, 1.0)), None

    zbuf, _ = jax.lax.scan(
        body,
        jnp.ones((dim if band_h is None else band_h, dim), jnp.float32),
        chunks)
    return zbuf
