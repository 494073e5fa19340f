"""Multi-chip rendering: framebuffer row-band sharding over a device Mesh.

The reference has no distributed mode (its only parallelism is host
threading, reference src/lib.rs:1399-1650); the natural scale axis is
screen-space data parallelism: each device rasterizes and shades a
horizontal band of the framebuffer.

Design (SURVEY §5.8):
* the (small) scene and per-frame state are replicated on every chip —
  there is no per-frame scene communication at all;
* the vertex stage + triangle setup run replicated (cheap, avoids an
  all-gather of clip coordinates);
* each chip rasterizes only its rows (`passes/frame.render_band` — the
  SAME pipeline body the single-chip path jits, so the two cannot drift):
  the band's tile binning makes off-band triangles nearly free, and every
  backend (tile kernel on a GPU, XLA oracle on the CPU), render mode, and
  the deferred pipeline work sharded;
* a FRESH shadow map is itself row-sharded: each chip rasters its band
  of the light-space map and one ``all_gather`` assembles the full
  (replicated) map — the only per-frame collective, amortizing the
  shadow raster across chips; a host-cached map may be passed in
  exactly like the single-chip path (then there is no collective);
* frame assembly is just the sharded output array: `jax.device_get`
  performs one device→host DMA per band (or leave it sharded for a
  sharded display/encoder).

Collectives: one shadow-map ``all_gather`` per frame in fresh-shadow
mode, none otherwise.  The renderer is embarrassingly data-parallel over
pixels, so the mesh buys nearly linear scaling until the per-chip band
becomes overhead-bound.

DEBUG mode composites band-aware (passes/overlay.py ``*_band`` variants
mask in global screen coordinates instead of static slices); the
scene-depth quad adds one DEBUG-only ``all_gather`` of the per-band depth
so every chip can sample the full depth image.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from kanirenderer_tpu.core.types import FrameState, RenderConfig, Scene
from kanirenderer_tpu.passes.frame import FrameOutputs, render_band

Array = jnp.ndarray


def make_mesh(devices=None, axis: str = "rows") -> Mesh:
    import numpy as np
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _band_geometry(config: RenderConfig, n: int, interleave: bool):
    """(band_h, y0 step) for contiguous or interleaved row bands."""
    if not interleave:
        return config.height // n, None
    tiles_full = -(-config.height // config.tile_h)
    tiles_band = -(-tiles_full // n)
    return tiles_band * config.tile_h, config.tile_h


def deinterleave_rows(arr, n: int, tile_h: int, height: int):
    """Reassemble an interleave-sharded row-band stack (host or device):
    stacked (n·J·tile_h, …) band-major → global row order, cropped to
    ``height``.  Chip k's band row block j is global tile row
    j·n + k."""
    import numpy as _np
    xp = _np if isinstance(arr, _np.ndarray) else jnp
    J = arr.shape[0] // (n * tile_h)
    a = arr.reshape((n, J, tile_h) + arr.shape[1:])
    a = xp.swapaxes(a, 0, 1)
    return a.reshape((n * J * tile_h,) + arr.shape[1:])[:height]


@partial(jax.jit, static_argnames=("config", "mesh", "axis", "interleave"))
def _render_sharded(scene: Scene, state: FrameState, config: RenderConfig,
                    mesh: Mesh, axis: str,
                    shadow_map: Array | None,
                    interleave: bool = False) -> FrameOutputs:
    n = mesh.devices.size
    band_h, step = _band_geometry(config, n, interleave)

    def band(scene, state, shadow_map):
        y0 = (jax.lax.axis_index(axis)
              * (step if interleave else band_h)).astype(jnp.float32)
        out = render_band(scene, state, config, shadow_map=shadow_map,
                          band_h=band_h, y0=y0, band_axis=axis,
                          band_stride=n if interleave else 1)
        return out.image, out.depth

    specs_in = (P(), P(), P())
    fn = shard_map(band, mesh=mesh, in_specs=specs_in,
                   out_specs=(P(axis, None, None), P(axis, None)),
                   check_vma=False)
    image, depth = fn(scene, state, shadow_map)
    return FrameOutputs(image=image, depth=depth,
                        shadow=jnp.zeros((1, 1), jnp.float32))


def render_frame_sharded(scene: Scene, state: FrameState,
                         config: RenderConfig, mesh: Mesh,
                         shadow_map: Array | None = None,
                         interleave: bool = False) -> FrameOutputs:
    """Render one frame with the framebuffer row-sharded over ``mesh``.

    Returns ``FrameOutputs`` whose image (H, W, 3) and depth (H, W) are
    sharded over rows.  config.height must be divisible by the mesh size.
    ``shadow_map``: optional host-cached shadow map (replicated to every
    chip), same semantics as ``render_frame``'s static-external path.

    ``interleave``: INTERLEAVED tile-row bands instead of contiguous ones
    (load balancing): a contiguous split is gated by the heaviest band,
    while interleaving spreads content skew to tile-row granularity.  The returned
    image/depth rows are band-major; reassemble with
    ``deinterleave_rows(np.asarray(out.image), n, config.tile_h,
    config.height)``.  Not supported in DEBUG mode (its overlays anchor
    to contiguous rows).
    """
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    if interleave:
        if shadow_map is None:
            return _render_sharded_fresh(scene, state, config, mesh, axis,
                                         interleave=True)
        return _render_sharded(scene, state, config, mesh, axis, shadow_map,
                               interleave=True)
    assert config.height % n == 0, "height must divide across the mesh"
    if shadow_map is None:
        # Static None must not reach jit as a pytree leaf of changing
        # structure; the band body treats a 1x1 zeros map as "render fresh"
        # via the explicit sentinel below.
        return _render_sharded_fresh(scene, state, config, mesh, axis)
    return _render_sharded(scene, state, config, mesh, axis, shadow_map)


@partial(jax.jit,
         static_argnames=("config", "mesh", "axis", "interleave"))
def _render_sharded_fresh(scene: Scene, state: FrameState,
                          config: RenderConfig, mesh: Mesh,
                          axis: str,
                          interleave: bool = False) -> FrameOutputs:
    n = mesh.devices.size
    band_h, step = _band_geometry(config, n, interleave)

    def band(scene, state):
        y0 = (jax.lax.axis_index(axis)
              * (step if interleave else band_h)).astype(jnp.float32)
        out = render_band(scene, state, config, band_h=band_h, y0=y0,
                          shadow_axis=axis,
                          shadow_bands=mesh.devices.size,
                          band_axis=axis,
                          band_stride=n if interleave else 1)
        return out.image, out.depth

    fn = shard_map(band, mesh=mesh, in_specs=(P(), P()),
                   out_specs=(P(axis, None, None), P(axis, None)),
                   check_vma=False)
    image, depth = fn(scene, state)
    return FrameOutputs(image=image, depth=depth,
                        shadow=jnp.zeros((1, 1), jnp.float32))
