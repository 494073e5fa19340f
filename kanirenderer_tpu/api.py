"""Public API — mirrors the reference's entry surface.

``run(file_path, file_type, fullscreen_mode, use_hdr)`` mirrors
``pub async fn run`` (reference src/lib.rs:2054) / the C ABI
``run_kanirenderer`` (src/lib.rs:2174-2192): load the model (default cube
when the path is empty/missing — src/resources.rs:73-79), build the render
state, and drive the event loop.  On a headless host the "window" is a
display sink (PNG/GIF/window, see runtime/display.py) and input comes from
an event source (scripted by default).
"""

from __future__ import annotations

import os

import numpy as np

from kanirenderer_tpu.backend import render_config
from kanirenderer_tpu.core.types import RenderMode
from kanirenderer_tpu.runtime.loop import run_loop, scripted_flythrough


def load_model_or_default(file_path: str, file_type: str = "opengl",
                          instances: int = 1):
    """Reference load_model fallback chain (src/resources.rs:73-79):
    empty/missing path → the embedded default cube.

    Returns (scene, builder); the builder supports file-drop appends."""
    import numpy as np
    from kanirenderer_tpu.io import obj as obj_mod
    from kanirenderer_tpu.io.scene_loader import SceneBuilder
    from kanirenderer_tpu.models.procedural import make_cube_obj

    builder = SceneBuilder()
    parsed = None
    tex_dir = "."
    if file_path and os.path.exists(file_path):
        # ANY load error → default cube, like the reference's
        # .unwrap_or(load_default_cube) (src/resources.rs:76-79).
        try:
            parsed = obj_mod.load_obj(file_path)
            tex_dir = os.path.dirname(os.path.abspath(file_path))
        except Exception as e:
            print(f"failed to load {file_path!r} ({e!r}), using default cube")
    elif file_path:
        print(f"{file_path!r} not found, using default cube")
    if parsed is None:
        parsed = obj_mod.parse_obj(make_cube_obj(), mtl_loader=lambda p: None)
    builder.add_model(parsed, tex_dir, file_type=file_type,
                      instances=instances, rng=np.random.RandomState(0))
    return builder.build(), builder


def run(file_path: str = "", file_type: str = "opengl",
        fullscreen_mode: str = "windowed", use_hdr: bool = False,
        width: int = 1440, height: int = 1080,
        mode: RenderMode = RenderMode.LIT_SHADOW,
        frames: int = 60, sink: str = "png", out: str | None = None,
        events=None, raster_backend: str | None = None,
        verbose: bool = True, profile_dir: str | None = None,
        point_lights: int = 1, render_scale: int = 1) -> dict:
    """Load + render loop (reference run(), src/lib.rs:2054-2168).

    Defaults match the reference: 1440×1080 window (src/lib.rs:2056),
    initial mode LitWithShadow (src/lib.rs:1033), LDR unless use_hdr.

    Embedding hosts using the fixed-signature C ABI can override the
    headless runtime via env vars: KANI_WIDTH, KANI_HEIGHT, KANI_FRAMES,
    KANI_SINK (png|gif|window|null), KANI_OUT, KANI_MODE, KANI_PROFILE
    (a directory: write a jax.profiler trace of the run — the deep
    companion to the on-screen frame-time graph, SURVEY §5.1),
    KANI_RENDER_SCALE.

    ``raster_backend``: None picks it from the JAX platform
    (kanirenderer_tpu.backend.raster_backend).
    """
    width = int(os.environ.get("KANI_WIDTH", width))
    height = int(os.environ.get("KANI_HEIGHT", height))
    # Performance mode: render at 1/s resolution.
    render_scale = int(os.environ.get("KANI_RENDER_SCALE", render_scale))
    if render_scale > 1:
        width //= render_scale
        height //= render_scale
    frames = int(os.environ.get("KANI_FRAMES", frames))
    sink = os.environ.get("KANI_SINK", sink)
    out = os.environ.get("KANI_OUT", out)
    if "KANI_MODE" in os.environ:
        mode = RenderMode[os.environ["KANI_MODE"].upper()]
    profile_dir = os.environ.get("KANI_PROFILE", profile_dir)
    scene, builder = load_model_or_default(file_path, file_type)
    overrides = dict(width=width, height=height, mode=mode, hdr=use_hdr)
    if raster_backend is not None:
        overrides["raster_backend"] = raster_backend
    cfg = render_config(**overrides)
    # Interactive path: a live window is both sink and event source —
    # flying the camera with WASD/mouse works like the reference's winit
    # loop (src/lib.rs:2091-2140).  Headless hosts fall back to scripted
    # events + the PNG-dumping window sink.
    sink_obj = None
    if sink == "window" and events is None:
        try:
            from kanirenderer_tpu.runtime.input import (InteractiveWindow,
                                                        interactive_source)
            sink_obj = InteractiveWindow(
                width, height, fullscreen=(fullscreen_mode == "fullscreen"))
            events = interactive_source(sink_obj)
        except Exception as e:
            if verbose:
                print(f"no display ({e!r}); falling back to scripted events")
    if events is None:
        events = scripted_flythrough(frames)
    def _go():
        return run_loop(scene, events, config=cfg, sink_kind=sink,
                        sink_path=out,
                        max_frames=frames if frames > 0 else None,
                        verbose=verbose,
                        builder=builder, file_type=file_type, sink=sink_obj,
                        point_lights=point_lights)

    if profile_dir:
        import jax
        with jax.profiler.trace(profile_dir):
            stats = _go()
    else:
        stats = _go()
    if verbose:
        print(f"rendered {stats['frames']} frames, "
              f"{stats['mean_ms']:.2f} ms avg ({stats['fps']:.1f} FPS), "
              f"mode {stats['mode']}, fullscreen={fullscreen_mode}")
    return stats
