"""render_frame — the whole per-frame pipeline as one jitted function.

The equivalent of State::update + State::render (reference
src/lib.rs:1382-2046): camera/light uniform math, optional shadow pass,
main visibility-buffer raster, mode-selected shading, debug overlays, and
surface encoding, all fused under one ``jax.jit`` with the render mode as
static configuration (the reference's six prebuilt pipelines become five
compiled executables).

Pass sequence per mode (matching src/lib.rs:1707-1914):
  UNLIT / LIT / WIREFRAME: main raster → shade
  LIT_SHADOW:              shadow raster → main raster → shade(PCF)
  DEBUG:                   LIT_SHADOW shading + depth/shadow quad +
                           frame-time graph overlays
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from kanirenderer_tpu.core import math3d
from kanirenderer_tpu.core.color import linear_to_srgb
from kanirenderer_tpu.core.types import (DebugTexture, FrameState,
                                         RenderConfig, RenderMode, Scene)
from kanirenderer_tpu.ops import raster_tiles, raster_xla
from kanirenderer_tpu.ops.interpolate import (build_tri_records,
                                              build_tri_records_corners,
                                              interpolate_records)
from kanirenderer_tpu.ops.sampling import build_shadow_table
from kanirenderer_tpu.ops.vertex import (run_vertex_stage,
                                         run_vertex_stage_corners,
                                         triangle_setup,
                                         triangle_setup_corners)
from kanirenderer_tpu.passes import overlay
from kanirenderer_tpu.shade import forward

Array = jnp.ndarray


class FrameOutputs(NamedTuple):
    image: Array   # (H, W, 3) display-encoded (sRGB LDR / linear HDR);
    #   f32, or uint8 when RenderConfig.output_u8 (the real surface format)
    depth: Array   # (H, W) f32 scene depth (for picking / debug)
    shadow: Array  # (shadow_dim, shadow_dim) f32 (all-ones when pass skipped)
    raster_overflow: Array = jnp.zeros((), jnp.int32)  # () i32 — chunks
    #   dropped by binning capacity caps (0 = complete geometry; the host
    #   loop warns when nonzero — capacity overruns must not be silent)


def _raster_interpolate(scene: Scene, vout, st, cfg: RenderConfig,
                        wireframe: bool, use_corners: bool,
                        band_h: int | None = None,
                        y0=None, band_stride: int = 1):
    """Visibility raster (tile kernel or the brute-force oracle), then the
    per-pixel record gather (ops/interpolate.py).

    ``band_h``/``y0`` restrict output to screen rows [y0, y0+band_h) for
    the row-band sharding path (parallel/mesh.py)."""
    if cfg.raster_backend == "tile":
        vis = raster_tiles.rasterize(st, cfg, wireframe=wireframe,
                                     band_h=band_h, y0=y0,
                                     y_stride=band_stride)
    else:
        vis = raster_xla.rasterize_xla(
            st.setup, cfg.width, cfg.height if band_h is None else band_h,
            wireframe=wireframe, wire_thresh=cfg.wire_thresh_px,
            y_offset=0.0 if y0 is None else y0,
            y_stride=band_stride, tile_h=cfg.tile_h)
    if use_corners:
        records = build_tri_records_corners(vout.varyings, scene.tri_extra)
    else:
        records = build_tri_records(scene.tri_idx, scene.tri_mat,
                                    vout.varyings, scene.mat_blk_base,
                                    scene.mat_blk_w, scene.mat_tex_size,
                                    extra=scene.tri_extra)
    return interpolate_records(vis, records)


def _rasterize_depth(st, cfg: RenderConfig, band_h: int | None = None,
                     y0=None, bins=None):
    if cfg.raster_backend == "tile":
        return raster_tiles.rasterize_depth(st, cfg, band_h=band_h, y0=y0,
                                            bins=bins)
    return raster_xla.rasterize_depth_xla(
        st.setup, cfg.shadow_dim, band_h=band_h,
        y_offset=0.0 if y0 is None else y0)


@partial(jax.jit, static_argnames=("config",))
def render_shadow_map(scene: Scene, state: FrameState,
                      config: RenderConfig) -> Array:
    """Standalone shadow-map pass (reference src/lib.rs:1721-1751).

    Exposed separately so the host loop can cache the map across frames
    while the sun and geometry are unchanged (the camera doesn't affect
    it) — the reference re-renders it every frame, we memoize.
    """
    cfg = config
    light_vp = math3d.directional_light_view_projection(
        state.lights.directional.direction,
        state.lights.directional.distance,
        state.lights.directional.shadow_scene_size)
    model = state.object_model[scene.vertex_object]
    world_pos = jnp.einsum("vij,vj->vi", model[:, :3, :3], scene.position,
                           precision=jax.lax.Precision.HIGHEST) \
        + model[:, :3, 3]
    light_clip = math3d.transform_points_h(light_vp, world_pos)
    sh_setup = triangle_setup(
        light_clip, scene.tri_idx, scene.tri_valid,
        cfg.shadow_dim, cfg.shadow_dim, cull_backfaces=False,
        depth_bias_constant=cfg.shadow_bias_constant,
        depth_bias_slope=cfg.shadow_bias_slope)
    return _rasterize_depth(sh_setup, cfg)


@partial(jax.jit, static_argnames=("config",))
def render_shadow_table(scene: Scene, state: FrameState,
                        config: RenderConfig) -> Array:
    """The shadow map's prebuilt PCF table (ops/sampling.build_shadow_table)
    — what ``render_frame(shadow_table=·)`` consumes for LIT_SHADOW."""
    return build_shadow_table(render_shadow_map(scene, state, config))


@partial(jax.jit, static_argnames=("config",))
def camera_setup(scene: Scene, state: FrameState, config: RenderConfig):
    """The main raster's TriangleSetup for ``state`` (back faces culled;
    vertex-major) — the input the raster backends share, exposed for
    kernel-level checks and timing."""
    cfg = config
    proj = math3d.perspective(jnp.deg2rad(cfg.fovy_deg), cfg.aspect,
                              cfg.znear, cfg.zfar)
    view = math3d.camera_view_matrix(state.camera.position, state.camera.yaw,
                                     state.camera.pitch)
    view_proj = jnp.matmul(proj, view, precision=jax.lax.Precision.HIGHEST)
    model = state.object_model[scene.vertex_object]
    world_pos = jnp.einsum("vij,vj->vi", model[:, :3, :3], scene.position,
                           precision=jax.lax.Precision.HIGHEST) \
        + model[:, :3, 3]
    return triangle_setup(math3d.transform_points_h(view_proj, world_pos),
                          scene.tri_idx, scene.tri_valid, cfg.width,
                          cfg.height, cull_backfaces=True)


@partial(jax.jit, static_argnames=("config",))
def render_shadow_geometry(scene: Scene, state: FrameState,
                           config: RenderConfig):
    """(light-space TriangleSetup, bins) for the fresh-shadow pass.

    Both are CAMERA-independent — they change only when the sun or the
    geometry moves — so fresh-mode callers (the reference re-renders the
    shadow map inside every frame, src/lib.rs:1721-1751) cache them across
    frames and pass them to ``render_frame(shadow_geom=·)``: the map still
    re-rasters per frame, but the per-frame light vertex transform, setup
    and binning drop out.  ``bins`` is None on the XLA backend (its depth
    raster is brute-force)."""
    cfg = config
    light_vp = math3d.directional_light_view_projection(
        state.lights.directional.direction,
        state.lights.directional.distance,
        state.lights.directional.shadow_scene_size)
    use_corners = (scene.corner_pos.shape[0] > 0
                   and cfg.raster_backend == "tile")
    if use_corners:
        vout = run_vertex_stage_corners(
            scene, state.object_model, state.object_normal,
            jnp.eye(4, dtype=jnp.float32), state.camera.position,
            state.lights, light_vp)
        sh_setup = triangle_setup_corners(
            vout.light_clip, scene.tri_valid,
            cfg.shadow_dim, cfg.shadow_dim, cull_backfaces=False,
            depth_bias_constant=cfg.shadow_bias_constant,
            depth_bias_slope=cfg.shadow_bias_slope)
    else:
        model = state.object_model[scene.vertex_object]
        world_pos = jnp.einsum(
            "vij,vj->vi", model[:, :3, :3], scene.position,
            precision=jax.lax.Precision.HIGHEST) + model[:, :3, 3]
        light_clip = math3d.transform_points_h(light_vp, world_pos)
        sh_setup = triangle_setup(
            light_clip, scene.tri_idx, scene.tri_valid,
            cfg.shadow_dim, cfg.shadow_dim, cull_backfaces=False,
            depth_bias_constant=cfg.shadow_bias_constant,
            depth_bias_slope=cfg.shadow_bias_slope)
    bins = None
    if cfg.raster_backend == "tile":
        bins = raster_tiles.shadow_bins(sh_setup, cfg)
    return sh_setup, bins


def render_band(scene: Scene, state: FrameState,
                config: RenderConfig,
                shadow_map: Array | None = None,
                use_cached_shadow: Array | None = None,
                *, shadow_table: Array | None = None,
                shadow_geom=None,
                band_h: int | None = None, y0=None,
                shadow_axis: str | None = None,
                shadow_bands: int = 1,
                band_axis: str | None = None,
                view_wh: Array | None = None,
                band_stride: int = 1) -> FrameOutputs:
    """The frame pipeline body, optionally restricted to a row band.

    This is the ONE implementation of the per-frame pass sequence; both
    ``render_frame`` (full screen, jitted) and the multi-chip
    ``parallel.mesh.render_frame_sharded`` (one band per chip under
    shard_map) call it, so the pipelines cannot drift apart — mirroring
    how the reference's render-mode switch exists exactly once
    (src/lib.rs:1754-1862).

    ``band_h`` (static) / ``y0`` (traced, from ``lax.axis_index``) select
    screen rows [y0, y0+band_h).  DEBUG-mode overlays composite
    band-aware (overlay.*_band, global-coordinate masks); the scene-depth
    quad needs the FULL depth image, gathered over ``band_axis`` when
    given (one DEBUG-only collective) — with ``band_h`` but no
    ``band_axis`` the quad shows the band's own depth rows.

    ``shadow_axis``/``shadow_bands``: under shard_map, also shard the
    FRESH shadow raster — each chip rasters shadow_dim/shadow_bands map
    rows and an ``all_gather`` over ``shadow_axis`` assembles the
    full map on every chip (instead of every chip redundantly rendering
    all of it).  The gathered map matches the unsharded one to within
    ~1 ulp (the banded kernel re-anchors the depth-plane coefficients,
    c ← c + b·y0, which perturbs f32 rounding).
    """
    cfg = config
    mode = cfg.mode
    banded = band_h is not None
    # Interleaved row bands (load balancing — see
    # ops/raster_tiles.rasterize): the band is tile rows k, k+stride, … so content
    # skew spreads across chips; y0 must be k·tile_h.  DEBUG overlays
    # anchor to contiguous global rows and are not supported interleaved.
    if band_stride > 1:
        assert banded, "band_stride needs band_h"
        assert mode != RenderMode.DEBUG, \
            "DEBUG overlays are contiguous-band only"

    # Resize-without-recompile (reference State::resize is an instant
    # surface reconfigure, src/lib.rs:1166; an XLA recompile is not):
    # ``view_wh`` — a TRACED (2,) f32 [view_w, view_h] — makes the
    # projection aspect and the raster extent follow the live window size
    # while every static shape (tile grid, output buffers) stays at the
    # bucketed cfg.width × cfg.height padded target; the host crops the
    # output to the view at present (runtime/loop.py).  DEBUG overlays
    # stay anchored to the padded frame (documented limitation).
    if view_wh is not None:
        vw, vh = view_wh[0], view_wh[1]
        aspect = vw / vh
    else:
        vw, vh = cfg.width, cfg.height
        aspect = cfg.aspect

    # --- per-frame uniform math (≈ State::update, src/lib.rs:1382-1704) ---
    proj = math3d.perspective(jnp.deg2rad(cfg.fovy_deg), aspect,
                              cfg.znear, cfg.zfar)
    view = math3d.camera_view_matrix(state.camera.position, state.camera.yaw,
                                     state.camera.pitch)
    view_proj = jnp.matmul(proj, view,
                           precision=jax.lax.Precision.HIGHEST)
    light_vp = math3d.directional_light_view_projection(
        state.lights.directional.direction,
        state.lights.directional.distance,
        state.lights.directional.shadow_scene_size)

    # Corner-major geometry (static tri_idx expansion at scene build)
    # makes the whole geometry stage gather-free; hand-built scenes
    # without corner planes use the vertex-major path, and so does the
    # XLA oracle backend.
    use_corners = (scene.corner_pos.shape[0] > 0
                   and cfg.raster_backend == "tile")
    if use_corners:
        vout = run_vertex_stage_corners(
            scene, state.object_model, state.object_normal, view_proj,
            state.camera.position, state.lights, light_vp)
    else:
        vout = run_vertex_stage(scene, state.object_model,
                                state.object_normal, view_proj,
                                state.camera.position, state.lights,
                                light_vp)

    # --- shadow pass (modes LitWithShadow/Debug, src/lib.rs:1721-1751) ---
    # A host-cached map — or, for LIT_SHADOW, the prebuilt PCF block
    # TABLE (ops/sampling.build_shadow_table), which also skips the
    # in-frame table rebuild — may be supplied (see render_shadow_map).
    needs_shadow = mode in (RenderMode.LIT_SHADOW, RenderMode.DEBUG)
    external_shadow = (shadow_map is not None or shadow_table is not None) \
        and use_cached_shadow is None
    if shadow_table is not None:
        assert (mode == RenderMode.LIT_SHADOW and shadow_map is None
                and use_cached_shadow is None), \
            "shadow_table is only valid for LIT_SHADOW without a raw map"

    def _fresh_shadow():
        if shadow_geom is not None:
            # Cached camera-independent light-space setup (+ bins) — see
            # render_shadow_geometry.  The map itself still re-rasters.
            assert shadow_axis is None or shadow_bands <= 1, \
                "shadow_geom is full-map only (banded rasters re-anchor)"
            sh_st, sh_bins = shadow_geom
            return _rasterize_depth(sh_st, cfg, bins=sh_bins)
        if use_corners:
            sh_setup = triangle_setup_corners(
                vout.light_clip, scene.tri_valid,
                cfg.shadow_dim, cfg.shadow_dim, cull_backfaces=False,
                depth_bias_constant=cfg.shadow_bias_constant,
                depth_bias_slope=cfg.shadow_bias_slope)
        else:
            sh_setup = triangle_setup(
                vout.light_clip, scene.tri_idx, scene.tri_valid,
                cfg.shadow_dim, cfg.shadow_dim, cull_backfaces=False,
                depth_bias_constant=cfg.shadow_bias_constant,
                depth_bias_slope=cfg.shadow_bias_slope)
        if shadow_axis is None or shadow_bands <= 1:
            return _rasterize_depth(sh_setup, cfg)
        assert cfg.shadow_dim % shadow_bands == 0, \
            "shadow_dim must divide across the mesh"
        sb_h = cfg.shadow_dim // shadow_bands
        sy0 = (jax.lax.axis_index(shadow_axis) * sb_h).astype(jnp.float32)
        band = _rasterize_depth(sh_setup, cfg, band_h=sb_h, y0=sy0)
        if mode == RenderMode.LIT_SHADOW and sb_h % 8 == 0:
            # Sharded-TABLE fresh shadow: rather than every chip building
            # the whole PCF table from the gathered map, each
            # chip builds the table rows for its own map band (a 1-row-
            # above / 2-row-below ppermute halo makes it exact,
            # ops/sampling.build_shadow_table_band) and the one per-frame
            # all_gather moves the TABLE instead of the map.  DEBUG keeps
            # the map path (its overlay quad displays the raw map).
            from kanirenderer_tpu.ops.sampling import \
                build_shadow_table_band
            n = shadow_bands
            idx = jax.lax.axis_index(shadow_axis)
            up = jax.lax.ppermute(band[-1:], shadow_axis,
                                  [(k, k + 1) for k in range(n - 1)])
            top1 = jnp.where(idx == 0, band[0:1], up)
            dn = jax.lax.ppermute(band[:2], shadow_axis,
                                  [(k, k - 1) for k in range(1, n)])
            bot2 = jnp.where(idx == n - 1,
                             jnp.concatenate([band[-1:], band[-1:]]), dn)
            tband = build_shadow_table_band(band, top1, bot2,
                                            cfg.shadow_dim)
            return ("table",
                    jax.lax.all_gather(tband, shadow_axis, axis=0,
                                       tiled=True))
        return jax.lax.all_gather(band, shadow_axis, axis=0, tiled=True)

    shadow_tbl_pre = None
    if shadow_table is not None:
        shadow_emit = None
    elif not needs_shadow:
        shadow_map = jnp.ones((cfg.shadow_dim, cfg.shadow_dim), jnp.float32)
        shadow_emit = shadow_map
    elif use_cached_shadow is not None:
        assert shadow_map is not None, \
            "use_cached_shadow requires a shadow_map buffer"
        # One executable, both paths: a fresh frame renders and EMITS the
        # map (the host caches it); a cached frame skips the raster and
        # emits zeros (no input is passed through to an output, so the
        # executable never aliases a caller's buffer).
        shadow_map, shadow_emit = jax.lax.cond(
            use_cached_shadow,
            lambda: (shadow_map,
                     jnp.zeros((cfg.shadow_dim, cfg.shadow_dim),
                               jnp.float32)),
            lambda: (lambda m: (m, m))(_fresh_shadow()))
    elif shadow_map is None:
        fresh = _fresh_shadow()
        if isinstance(fresh, tuple) and fresh[0] == "table":
            shadow_tbl_pre = fresh[1]
            shadow_map = None
            shadow_emit = jnp.zeros((1, 1), jnp.float32)
        else:
            shadow_map = fresh
            shadow_emit = shadow_map
    else:
        shadow_emit = None  # statically external

    # --- main raster + varying interpolation ---
    wireframe = mode == RenderMode.WIREFRAME
    if use_corners:
        setup = triangle_setup_corners(
            vout.clip, scene.tri_valid, vw, vh,
            cull_backfaces=not wireframe)
    else:
        setup = triangle_setup(vout.clip, scene.tri_idx, scene.tri_valid,
                               vw, vh,
                               cull_backfaces=not wireframe)
    pix = _raster_interpolate(scene, vout, setup, cfg, wireframe,
                              use_corners, band_h=band_h, y0=y0,
                              band_stride=band_stride)

    # --- shading (channel-planar: color is (3, H, W)) ---
    if mode == RenderMode.UNLIT:
        color = forward.shade_unlit(scene, pix)
    elif mode == RenderMode.WIREFRAME:
        color = forward.shade_wireframe(pix)
    elif cfg.deferred:
        # Deferred path: G-buffer write + world-space lighting
        # (shade/deferred.py; the reference's stubbed design realized).
        from kanirenderer_tpu.shade import deferred as deferred_mod
        gbuf = deferred_mod.write_gbuffer(scene, pix, state.camera.position,
                                          light_vp)
        if mode in (RenderMode.LIT_SHADOW, RenderMode.DEBUG):
            srows = shadow_tbl_pre if shadow_tbl_pre is not None \
                else build_shadow_table(shadow_map)
        else:
            srows = None
        color = deferred_mod.deferred_lighting(gbuf, state.lights, srows,
                                               cfg.hdr, cfg.shadow_dim)
    elif mode == RenderMode.LIT:
        color = forward.shade_lit(scene, pix, state.lights, None, cfg.hdr,
                                  camera_pos=state.camera.position)
    else:  # LIT_SHADOW or DEBUG
        if shadow_table is not None:
            shadow_tbl = shadow_table
        elif shadow_tbl_pre is not None:
            shadow_tbl = shadow_tbl_pre   # sharded-table fresh path
        else:
            shadow_tbl = build_shadow_table(shadow_map)
        color = forward.shade_lit(scene, pix, state.lights, shadow_tbl,
                                  cfg.hdr, cfg.shadow_dim,
                                  camera_pos=state.camera.position,
                                  light_vp=light_vp)

    clear = jnp.asarray(cfg.clear_color, jnp.float32)[:, None, None]
    image = jnp.where(pix.mask[None], color, clear)

    # --- surface encoding + overlays.  sRGB store for the LDR
    # Rgba8UnormSrgb surface, raw linear for the HDR Rgba16Float surface
    # (src/lib.rs:321-329).  Encode while still channel-planar
    # (elementwise, so it commutes with the transpose exactly).  DEBUG keeps the
    # overlays-then-encode order — overlay colors are linear values that
    # the surface encodes, like the reference's overlay pipelines
    # (src/lib.rs:1865-1914) — and encodes channel-last.
    def encode(img):
        return jnp.clip(img, 0.0, 1.0) if cfg.hdr else linear_to_srgb(img)

    def downscale(img, channel_last):
        # Present-path preview (RenderConfig.present_scale): box-average
        # the ENCODED surface by p on device so the host fetch moves p²
        # less data.  Sub-ms: a pure reshape-mean on the planar layout.
        p = cfg.present_scale
        if p <= 1:
            return img
        if channel_last:
            H, W = img.shape[0] // p * p, img.shape[1] // p * p
            return img[:H, :W].reshape(H // p, p, W // p, p, 3).mean((1, 3))
        H, W = img.shape[1] // p * p, img.shape[2] // p * p
        return img[:, :H, :W].reshape(3, H // p, p, W // p, p).mean((2, 4))

    def quantize(img):
        # On-device surface store: Rgba8 for LDR (== runtime/display.
        # to_uint8 exactly), Rgba16Float for HDR (src/lib.rs:321-329).
        if not cfg.output_u8:
            return img
        if cfg.hdr:
            return img.astype(jnp.float16)
        return jnp.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)

    if mode == RenderMode.DEBUG:
        image = jnp.transpose(image, (1, 2, 0))  # → (H, W, 3)
        if cfg.debug_texture == DebugTexture.SHADOW_MAP:
            dbg_tex = shadow_map
        elif banded and band_axis is not None:
            # The quad visualizes the FULL scene depth; each band only
            # rasterized its rows, so assemble it once over the mesh
            # (DEBUG-only collective — not on any perf path).
            dbg_tex = jax.lax.all_gather(pix.z, band_axis, axis=0,
                                         tiled=True)
        else:
            dbg_tex = pix.z
        if banded:
            row0 = jnp.float32(0.0) if y0 is None else y0
            image = overlay.debug_texture_quad_band(
                image, row0, cfg.height, dbg_tex, cfg.znear, cfg.zfar)
            image = overlay.frame_time_graph_band(
                image, row0, cfg.height, state.frame_times_ms)
        else:
            image = overlay.debug_texture_quad(image, dbg_tex, cfg.znear,
                                               cfg.zfar)
            image = overlay.frame_time_graph(image, state.frame_times_ms)
        image = quantize(downscale(encode(image), channel_last=True))
    else:
        image = jnp.transpose(
            quantize(downscale(encode(image), channel_last=False)),
            (1, 2, 0))
    if external_shadow or shadow_emit is None:
        # No input buffer is passed through to an output (no aliasing of
        # the caller's buffers); the caller already holds the map it
        # passed in.
        shadow_out = jnp.zeros((1, 1), jnp.float32)
    else:
        shadow_out = shadow_emit
    return FrameOutputs(image=image, depth=pix.z, shadow=shadow_out,
                        raster_overflow=pix.overflow)


@partial(jax.jit, static_argnames=("config",))
def render_frame(scene: Scene, state: FrameState,
                 config: RenderConfig,
                 shadow_map: Array | None = None,
                 use_cached_shadow: Array | None = None,
                 shadow_table: Array | None = None,
                 shadow_geom=None,
                 view_wh: Array | None = None) -> FrameOutputs:
    """Render one full frame (jitted; one executable per static config).

    Shadow-map caching (steady-state interactive behavior; the reference
    re-renders per frame, src/lib.rs:1721): pass the cached map as
    ``shadow_map`` plus a traced bool ``use_cached_shadow``.  The shadow
    raster is then skipped via ``lax.cond`` inside the same executable.
    With ``use_cached_shadow`` None the map is statically external.
    ``shadow_table``: a prebuilt PCF table (LIT_SHADOW only), the
    interactive loop's cached-shadow path.
    """
    return render_band(scene, state, config, shadow_map, use_cached_shadow,
                       shadow_table=shadow_table, shadow_geom=shadow_geom,
                       view_wh=view_wh)


def linearize_depth(depth: Array, znear: float, zfar: float) -> Array:
    """Depth-picking linearization (reference src/lib.rs:2000-2013)."""
    return znear * zfar / (zfar - depth * (zfar - znear))
