"""Host render loop — the app layer (reference ``run()``, src/lib.rs:2054-2168).

Event-loop structure mapped to a headless-friendly design:

* an ``InputSource`` yields per-frame ``Events`` (key presses/holds, mouse
  deltas) — interactive backends can wrap a real window, while scripted
  sources drive demos/benchmarks/tests;
* controllers (runtime/controllers.py) integrate camera/light state;
* hotkeys replicate the reference bindings: Tab cycles render modes
  (src/lib.rs:1221-1229), Key1 toggles the debug texture
  (src/lib.rs:1282-1327), Key2/Key3 move the sun distance, R/T/Y rotate
  the sun (src/lib.rs:1329-1355), F1 cycles present modes
  (src/lib.rs:1248-1280 — here: frame pacing), F11 fullscreen (window
  backends only);
* each frame calls the jitted render_frame and presents via a display sink.

Mode changes swap the static RenderConfig → a different compiled executable,
mirroring the reference's prebuilt-pipeline switch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from kanirenderer_tpu.core.types import (DebugTexture, FrameState, Lights,
                                         RenderConfig, RenderMode, Scene,
                                         default_camera, default_lights)
from kanirenderer_tpu.passes.frame import (render_frame, render_shadow_table,
                                           linearize_depth)
from kanirenderer_tpu.runtime import controllers
from kanirenderer_tpu.runtime.display import make_sink, to_uint8
from kanirenderer_tpu.runtime.frametime import FrameTimeGraph
from kanirenderer_tpu.utils import log


class Events(NamedTuple):
    """One frame's worth of input."""

    held: frozenset = frozenset()      # currently-held key names
    pressed: frozenset = frozenset()   # keys newly pressed this frame
    mouse_dx: float = 0.0
    mouse_dy: float = 0.0
    mouse_look: bool = False           # RMB held (src/lib.rs:1365-1369)
    scroll: float = 0.0
    click_pos: tuple | None = None     # LMB depth-pick (src/lib.rs:1370-1376)
    dropped_file: str | None = None    # file drop adds a model
    #                                    (src/lib.rs:2122-2137)
    resize: tuple | None = None        # (w, h) window resize
    #                                    (State::resize, src/lib.rs:1166)
    quit: bool = False


PRESENT_MODES = ["AutoVsync", "AutoNoVsync", "Fifo", "Immediate"]

# Render-target size ladder for drag-resize (State::resize is an instant
# surface reconfigure in the reference, src/lib.rs:1166; here a changed
# static shape is an XLA recompile — seconds).  Resizes render into the
# next ladder size ≥ the view (at
# most a handful of executables per session, each compiled once and then
# cache-hit on revisit) while the TRACED view size drives projection and
# raster extent (passes/frame.render_band view_wh) and the host crops the
# padded output to the view at present — exact framing, no recompile
# between ladder steps.
_SIZE_LADDER = (256, 384, 512, 768, 1024, 1280, 1536, 1920, 2560, 3840)


def _bucket(v: int) -> int:
    for s in _SIZE_LADDER:
        if v <= s:
            return s
    return -(-int(v) // 128) * 128


@dataclasses.dataclass
class AppState:
    """Mutable host-side app state (≈ the non-GPU parts of struct State)."""

    config: RenderConfig
    camera: object
    lights: Lights
    present_mode: int = 0
    fullscreen: bool = False

    def cycle_mode(self):
        self.config = self.config.with_(mode=self.config.mode.next())

    def toggle_debug_texture(self):
        nxt = DebugTexture((int(self.config.debug_texture) + 1) % 2)
        self.config = self.config.with_(debug_texture=nxt)


def _camera_inputs(ev: Events) -> controllers.CameraInputs:
    h = ev.held
    return controllers.CameraInputs(
        forward=1.0 if ("w" in h or "up" in h) else 0.0,
        backward=1.0 if ("s" in h or "down" in h) else 0.0,
        left=1.0 if ("a" in h or "left" in h) else 0.0,
        right=1.0 if ("d" in h or "right" in h) else 0.0,
        up=1.0 if "space" in h else 0.0,
        down=1.0 if "lshift" in h else 0.0,
        rotate_dx=ev.mouse_dx if ev.mouse_look else 0.0,
        rotate_dy=ev.mouse_dy if ev.mouse_look else 0.0,
        scroll=ev.scroll * -100.0,
    )


def _light_inputs(ev: Events) -> controllers.LightInputs:
    h, p = ev.held, ev.pressed
    return controllers.LightInputs(
        forward=1.0 if "i" in h else 0.0,
        backward=1.0 if "k" in h else 0.0,
        left=1.0 if "j" in h else 0.0,
        right=1.0 if "l" in h else 0.0,
        up=1.0 if "u" in h else 0.0,
        down=1.0 if "o" in h else 0.0,
        d_range=(1.0 if "=" in p else 0.0) - (1.0 if "-" in p else 0.0),
        d_color=(1.0 if "]" in p else 0.0) - (1.0 if "[" in p else 0.0),
    )


def run_loop(scene: Scene, events: Iterable[Events],
             config: RenderConfig | None = None,
             sink_kind: str = "null", sink_path: str | None = None,
             max_frames: int | None = None,
             verbose: bool = False, builder=None,
             file_type: str = "opengl", sink=None,
             point_lights: int = 1) -> dict:
    """Drive frames from an event stream.  Returns run statistics.

    ``builder``: the SceneBuilder that produced ``scene`` — required to
    honor file-drop events (the scene is rebuilt with the new model
    appended, like the reference's drop handler, src/lib.rs:2122-2137).

    ``sink``: an already-constructed sink (e.g. an InteractiveWindow that
    is also the event source); overrides ``sink_kind``.
    """
    cfg = config or RenderConfig()
    # Present frames in the real surface format — uint8 for LDR
    # (Rgba8UnormSrgb), float16 for HDR (Rgba16Float; src/lib.rs:321-329)
    # — so the per-frame device→host transfer shrinks 4x/2x and LDR
    # needs no host convert.
    cfg = cfg.with_(output_u8=True)
    lights = default_lights()
    if point_lights > 1:
        from kanirenderer_tpu.core.types import spawn_point_lights
        lights = lights._replace(points=spawn_point_lights(point_lights))
    app = AppState(config=cfg, camera=default_camera(), lights=lights)
    if sink is None:
        sink = make_sink(sink_kind, sink_path, cfg.width, cfg.height)
    graph = FrameTimeGraph()
    frames = 0
    last = time.perf_counter()
    picked: list = []
    # Shadow cache (steady-state interactive behavior; the reference
    # re-renders the map every frame, src/lib.rs:1721): the map only
    # depends on the sun and the geometry, not the camera, so the loop
    # keeps the prebuilt PCF block TABLE (ops/sampling.build_shadow_table)
    # on the device and feeds it to the frame executable — which then
    # skips both the shadow raster and the per-frame table rebuild.  The
    # table is re-rendered on the frame whose light key changes (so a
    # rotating sun re-renders every frame, like the reference); set
    # cache_shadow_map=False for the in-frame fresh shadow.
    shadow_table = None
    shadow_key = None
    warned_overflow = 0

    def _host(tree):
        return jax.tree.map(np.asarray, tree)

    # Scaling sinks (WindowSink / InteractiveWindow / null) take the
    # device-downsampled preview at NATIVE resolution plus the target
    # view size and zoom it themselves (PIL nearest, C speed); the
    # host-side np.repeat upscale is the fallback for frame-capturing
    # sinks (PNG/GIF and test capture sinks expect full-size buffers).
    sink_scales = bool(getattr(sink, "scales_preview", False))

    def _present(out, view, scale):
        """Fetch + finish + hand one frame to the sink."""
        img = np.asarray(to_uint8(out.image))
        if scale > 1:
            if sink_scales:
                # Crop the PREVIEW to the view's footprint; the sink
                # resizes to the exact view size.
                pv = (-(-view[0] // scale), -(-view[1] // scale)) \
                    if view is not None else None
                if pv is not None and (img.shape[1], img.shape[0]) != pv:
                    img = img[:pv[1], :pv[0]]
                sink.present(img, view=view)
                return
            img = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
        if view is not None and (img.shape[1], img.shape[0]) != view:
            img = img[:view[1], :view[0]]
        sink.present(img)

    # Swapchain-style double buffering: the frame dispatched on iteration
    # N is presented on iteration N+1 (one frame of latency, like any
    # real swapchain), so the device→host frame transfer of frame N
    # overlaps frame N+1's on-device compute.
    pending = None
    pending_view = None
    pending_scale = 1
    # Exact view size; differs from the (padded) config dims after a
    # resize — see _SIZE_LADDER.
    view_size = (cfg.width, cfg.height)

    for ev in events:
        if ev.quit or (max_frames is not None and frames >= max_frames):
            break
        now = time.perf_counter()
        dt = now - last
        last = now

        # --- file drop: append a model and rebuild the packed scene ---
        if ev.dropped_file is not None and builder is not None:
            import os as _os
            from kanirenderer_tpu.io import obj as _obj
            try:
                parsed = _obj.load_obj(ev.dropped_file)
                builder.add_model(
                    parsed,
                    _os.path.dirname(_os.path.abspath(ev.dropped_file)),
                    file_type=file_type)
                scene = builder.build()
                shadow_table = None  # geometry changed
                shadow_key = None
                if verbose:
                    log.info("added model %s", ev.dropped_file)
            except Exception as e:  # missing/corrupt file: keep rendering
                log.warn("file drop failed for %r: %s", ev.dropped_file, e)

        # --- window resize (State::resize, src/lib.rs:1166): the render
        # target snaps to the size LADDER (recompiles only on a ladder
        # step); the exact view size rides the trace (view_wh) and the
        # present path crops — see _SIZE_LADDER above ---
        if ev.resize is not None:
            w, h = ev.resize
            if w > 0 and h > 0:
                view_size = (int(w), int(h))
                bw, bh = _bucket(int(w)), _bucket(int(h))
                if (bw, bh) != (app.config.width, app.config.height):
                    app.config = app.config.with_(width=bw, height=bh)

        # --- hotkeys (State::input, src/lib.rs:1208-1379) ---
        p = ev.pressed
        if "tab" in p:
            app.cycle_mode()
        if "f1" in p:
            # Present-mode cycle (reference src/lib.rs:1248-1280).  The
            # headless analog of vsync is frame pacing: AutoVsync/Fifo cap
            # the loop at 60 Hz (see the sleep below), AutoNoVsync/
            # Immediate free-run.
            app.present_mode = (app.present_mode + 1) % len(PRESENT_MODES)
            log.info("present mode: %s", PRESENT_MODES[app.present_mode])
        if "f11" in p:
            # Fullscreen toggle with a real effect on window sinks
            # (reference src/lib.rs:1231-1247).
            app.fullscreen = not app.fullscreen
            if hasattr(sink, "set_fullscreen"):
                sink.set_fullscreen(app.fullscreen)
        if "1" in p:
            app.toggle_debug_texture()
        # Controllers run as pure numpy host math (the *_host twins), like
        # the reference's State::update (src/lib.rs:1382-1705): no device
        # dispatch or fetch per frame for a handful of scalars.
        d = app.lights.directional
        if "2" in p:
            d = controllers.step_directional_distance_host(d, -10.0)
        if "3" in p:
            d = controllers.step_directional_distance_host(d, +10.0)
        if "r" in ev.held:
            d = controllers.rotate_directional_light_host(d, 4.0, 0.0, 0.0)
        if "t" in ev.held:
            d = controllers.rotate_directional_light_host(d, 0.0, 4.0, 0.0)
        if "y" in ev.held:
            d = controllers.rotate_directional_light_host(d, 0.0, 0.0, 4.0)

        # --- controller integration (State::update) ---
        app.camera = controllers.update_camera_host(
            app.camera, _camera_inputs(ev), dt)
        app.lights = app.lights._replace(
            movable=controllers.update_movable_light_host(
                app.lights.movable, _light_inputs(ev), dt),
            directional=_host(d))

        # --- render ---
        graph.update(dt)
        state = FrameState(
            camera=app.camera, lights=app.lights,
            object_model=scene.object_model,
            object_normal=scene.object_normal,
            frame_times_ms=jnp.asarray(graph.buffer))
        # The prebuilt-table path applies to forward LIT_SHADOW (DEBUG's
        # overlay and the deferred shader consume the raw map in-frame).
        use_table = (app.config.mode == RenderMode.LIT_SHADOW
                     and app.config.cache_shadow_map
                     and not app.config.deferred)
        if use_table:
            d = app.lights.directional
            key = (app.config.shadow_dim,
                   tuple(np.asarray(d.direction).tolist()),
                   float(d.distance), float(d.shadow_scene_size))
            if shadow_table is None or key != shadow_key:
                shadow_table = render_shadow_table(scene, state, app.config)
                shadow_key = key
            tbl = shadow_table
        else:
            tbl = None
        vwh = None
        if view_size != (app.config.width, app.config.height):
            vwh = jnp.asarray(view_size, jnp.float32)
        if tbl is not None:
            out = render_frame(scene, state, app.config,
                               shadow_table=tbl, view_wh=vwh)
        else:
            out = render_frame(scene, state, app.config, view_wh=vwh)
        # Present the PREVIOUS frame (double buffering, see above): its
        # transfer overlaps the dispatch we just issued.
        if pending is not None:
            _present(pending, pending_view, pending_scale)
            # Binning capacity overruns must not silently drop geometry
            # (ops/binning.StreamBins.overflow): warn when the count
            # changes.  Checked every 8th frame — each scalar fetch is a
            # host↔device round trip, and capacity is config-static.
            if frames % 8 == 1:
                ov = int(np.asarray(pending.raster_overflow))
                if ov > 0 and ov != warned_overflow:
                    log.warn("raster binning dropped %d chunks this frame "
                             "— raise max_global_chunks (RenderConfig)", ov)
                    warned_overflow = ov
        pending = out
        pending_view = view_size
        pending_scale = app.config.present_scale
        frames += 1

        # --- frame pacing: the vsync-like present modes cap at 60 Hz ---
        if PRESENT_MODES[app.present_mode] in ("AutoVsync", "Fifo"):
            budget = 1.0 / 60.0 - (time.perf_counter() - now)
            if budget > 0:
                time.sleep(budget)

        # --- depth picking (src/lib.rs:1923-2039) ---
        if ev.click_pos is not None:
            x, y = ev.click_pos
            x = int(np.clip(x, 0, view_size[0] - 1))
            y = int(np.clip(y, 0, view_size[1] - 1))
            depth = float(np.asarray(out.depth)[y, x])
            lin = float(linearize_depth(jnp.float32(depth),
                                        app.config.znear, app.config.zfar))
            picked.append((x, y, depth, lin))
            if verbose:
                print(f"depth at ({x},{y}): raw={depth:.6f} linear={lin:.2f}")

        if verbose and frames % 60 == 0:
            print(f"frame {frames}: {graph.mean_ms:.2f} ms "
                  f"({graph.fps:.1f} FPS) mode={app.config.mode.name}")

    if pending is not None:  # flush the last double-buffered frame
        _present(pending, pending_view, pending_scale)
        ov = int(np.asarray(pending.raster_overflow))
        if ov > 0 and ov != warned_overflow:
            log.warn("raster binning dropped %d chunks — raise "
                     "max_global_chunks (RenderConfig)", ov)
    sink.close()
    return {
        "frames": frames,
        "mean_ms": graph.mean_ms,
        "fps": graph.fps,
        "mode": app.config.mode.name,
        "present_mode": PRESENT_MODES[app.present_mode],
        "picked": picked,
        "view_size": view_size,
        "render_size": (app.config.width, app.config.height),
    }


def scripted_flythrough(n_frames: int, look: bool = True) -> Iterable[Events]:
    """A deterministic W-forward + mouse-look event stream for demos/bench."""
    for i in range(n_frames):
        yield Events(held=frozenset(["w"]),
                     mouse_dx=2.0 if look else 0.0,
                     mouse_dy=0.3 if look else 0.0,
                     mouse_look=look)
