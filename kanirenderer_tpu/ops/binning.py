"""Per-frame tile binning for the tile rasterizer (ops/raster_tiles.py).

Screen space is divided into (tile_h × tile_w) tiles, and each tile gets
the list of *triangle chunks* (CHUNK_SIZE consecutive Morton-ordered
triangles, see io/scene_loader.py) whose triangles can cover one of its
pixels.  Because triangles are Morton-sorted at load, chunks are spatially
compact, so chunk-granularity binning costs ~T/CHUNK work instead of
O(T · tiles).

Scatter-free pipeline (all dense XLA):
 1. chunk screen bbox = min/max over each chunk's triangle bboxes, plus
    one bbox per SUBBATCH-triangle subbatch;
 2. each chunk expands to ≤ ``max_tiles_per_chunk`` (tile, chunk) slots;
    chunks spanning more tiles go to a small "global" list that is
    enumerated densely against every tile;
 3. every (tile, chunk) pair carries a subbatch overlap mask (one bit per
    subbatch whose bbox overlaps the tile); pairs with an empty mask are
    dropped — no triangle of theirs can cover a pixel of the tile;
 4. one key+payload sort by ``tile · C + chunk`` groups the pairs by tile
    in ascending chunk order, and per-tile ranges come from
    ``searchsorted``.

The ascending order is part of the contract: the kernel walks a tile's
chunks, subbatches and triangles in increasing triangle id and keeps the
first nearest hit, which is the brute-force oracle's tie rule.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from kanirenderer_tpu.core.types import (CHUNK_SIZE, SUBBATCH,
                                         SUBS_PER_CHUNK)

Array = jnp.ndarray

_SENTINEL = 2**31 - 1


class StreamBins(NamedTuple):
    """Flat sorted (tile, chunk) stream.

    Tile ``t`` owns stream entries ``[header[0, t], header[0, t] +
    header[1, t])``; each entry is ``(chunk id, subbatch mask)`` with bit
    ``s`` of the mask set iff subbatch ``s`` of the chunk overlaps the
    tile."""

    header: Array      # (2, num_tiles) i32: [first entry, entry count]
    stream: Array      # (N, 2) i32: [chunk id, subbatch mask], sorted
    #                    by (tile, chunk); entries past the last tile's
    #                    range are padding
    overflow: Array    # () i32 — chunks dropped by max_global_chunks


def max_key_tiles(num_chunks: int) -> int:
    """Largest tile count whose ``tile · C + chunk`` key fits an int32
    below the sort sentinel."""
    return (_SENTINEL - 1) // max(num_chunks, 1)


@partial(jax.jit, static_argnames=("tiles_x", "tiles_y", "tile_w", "tile_h",
                                   "max_tiles_per_chunk",
                                   "max_global_chunks"))
def bin_stream(bbox: Array, tiles_x: int, tiles_y: int, tile_w: int,
               tile_h: int, max_tiles_per_chunk: int = 16,
               max_global_chunks: int = 256) -> StreamBins:
    """bbox: (T, 4) f32 per-triangle pixel bounds from triangle_setup
    (invalid triangles carry empty boxes); T a multiple of CHUNK_SIZE."""
    S = max_tiles_per_chunk
    G = max_global_chunks
    num_tiles = tiles_x * tiles_y
    T = bbox.shape[0]
    if T % CHUNK_SIZE:
        raise ValueError(f"{T} triangles is not a multiple of {CHUNK_SIZE}")
    C = T // CHUNK_SIZE
    if num_tiles > max_key_tiles(C):
        raise ValueError(f"{num_tiles} tiles x {C} chunks overflows the "
                         "int32 binning key")

    # Planar (4, C, CHUNK) view: chunk and subbatch bounds are reductions
    # over the minor axis.
    bt = bbox.T.reshape(4, C, CHUNK_SIZE)
    cx0 = bt[0].min(axis=-1)
    cy0 = bt[1].min(axis=-1)
    cx1 = bt[2].max(axis=-1)
    cy1 = bt[3].max(axis=-1)
    nonempty = (cx1 > cx0) & (cy1 > cy0)
    sb = bt.reshape(4, C, SUBS_PER_CHUNK, SUBBATCH)
    sx0 = sb[0].min(axis=-1)                 # (C, SUBS_PER_CHUNK)
    sy0 = sb[1].min(axis=-1)
    sx1 = sb[2].max(axis=-1)
    sy1 = sb[3].max(axis=-1)
    weights = jnp.asarray([1 << s for s in range(SUBS_PER_CHUNK)], jnp.int32)

    def subbatch_bits(txi, tyi, gc):
        """Overlap bits of chunk ``gc``'s subbatch bboxes vs the tile at
        integer coords (txi, tyi); all three broadcast together."""
        tx0 = (txi * tile_w).astype(jnp.float32)[..., None]
        ty0 = (tyi * tile_h).astype(jnp.float32)[..., None]
        hit = ((sx0[gc] < tx0 + tile_w) & (sx1[gc] > tx0)
               & (sy0[gc] < ty0 + tile_h) & (sy1[gc] > ty0))
        return (hit.astype(jnp.int32) * weights).sum(axis=-1)

    tx0 = jnp.clip((cx0 // tile_w).astype(jnp.int32), 0, tiles_x - 1)
    ty0 = jnp.clip((cy0 // tile_h).astype(jnp.int32), 0, tiles_y - 1)
    tx1 = jnp.clip(((cx1 - 1.0) // tile_w).astype(jnp.int32), 0, tiles_x - 1)
    ty1 = jnp.clip(((cy1 - 1.0) // tile_h).astype(jnp.int32), 0, tiles_y - 1)
    span_w = tx1 - tx0 + 1
    span = span_w * (ty1 - ty0 + 1)
    glob = nonempty & (span > S)

    # Local chunks: (C, S) expansion slots.
    slots = jnp.arange(S, dtype=jnp.int32)[None, :]
    txi = tx0[:, None] + slots % span_w[:, None]
    tyi = ty0[:, None] + slots // span_w[:, None]
    cids = jnp.arange(C, dtype=jnp.int32)
    lmask = subbatch_bits(txi, tyi, cids[:, None])
    lvalid = (nonempty & (span <= S))[:, None] & (slots < span[:, None]) \
        & (lmask != 0)
    lkey = jnp.where(lvalid, (tyi * tiles_x + txi) * C + cids[:, None],
                     _SENTINEL)

    # Global chunks: the first G, enumerated against every tile.
    gsorted = jnp.sort(jnp.where(glob, cids, _SENTINEL))[:G]
    gc = jnp.minimum(gsorted, C - 1)
    tids = jnp.arange(num_tiles, dtype=jnp.int32)
    gmask = subbatch_bits((tids % tiles_x)[:, None],
                          (tids // tiles_x)[:, None], gc[None, :])
    gvalid = (gsorted != _SENTINEL)[None, :] & (gmask != 0)
    gkey = jnp.where(gvalid, tids[:, None] * C + gc[None, :], _SENTINEL)

    skey, smask = jax.lax.sort(
        (jnp.concatenate([lkey.reshape(-1), gkey.reshape(-1)]),
         jnp.concatenate([lmask.reshape(-1), gmask.reshape(-1)])),
        num_keys=1)
    starts = jnp.searchsorted(skey, tids * C).astype(jnp.int32)
    ends = jnp.searchsorted(skey, (tids + 1) * C).astype(jnp.int32)
    valid = skey != _SENTINEL
    stream = jnp.stack([jnp.where(valid, skey % C, 0),
                        jnp.where(valid, smask, 0)], axis=1)
    return StreamBins(
        header=jnp.stack([starts, ends - starts]),
        stream=stream,
        overflow=jnp.maximum(glob.sum() - G, 0).astype(jnp.int32),
    )
