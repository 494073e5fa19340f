"""Runtime layer: controllers, hotkeys, loop, depth picking, display sinks."""

import numpy as np
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.models.procedural import cube_scene
from kanirenderer_tpu.runtime import controllers
from kanirenderer_tpu.runtime.loop import Events, run_loop
from kanirenderer_tpu.runtime.frametime import FrameTimeGraph

SCENE = cube_scene()


def cam():
    return kani.default_camera()


def test_camera_wasd_moves_in_yaw_basis():
    # default yaw -90° → forward is -Z (reference src/camera.rs:173-177)
    c = controllers.update_camera(cam(), controllers.CameraInputs(forward=1),
                                  dt=0.1)
    p = np.asarray(c.position)
    assert p[2] < 10.0 - 25.0  # moved -Z by speed 300 * 0.1
    np.testing.assert_allclose(p[0], 0.0, atol=1e-4)

    c = controllers.update_camera(cam(), controllers.CameraInputs(right=1),
                                  dt=0.1)
    assert np.asarray(c.position)[0] > 25.0  # right of -Z view is +X


def test_camera_vertical_and_pitch_clamp():
    c = controllers.update_camera(cam(), controllers.CameraInputs(up=1),
                                  dt=0.5)
    assert np.asarray(c.position)[1] > 5.0 + 100.0
    # pitch clamps to ±(π/2 − 1e-4) (reference src/camera.rs:192-196)
    c = controllers.update_camera(cam(),
                                  controllers.CameraInputs(rotate_dy=-1e6),
                                  dt=1.0)
    assert abs(float(c.pitch)) <= 1.5707964 - 9e-5 + 1e-7


def test_camera_scroll_moves_along_view():
    c0 = cam()
    c = controllers.update_camera(c0, controllers.CameraInputs(scroll=1.0),
                                  dt=0.1)
    d = np.asarray(c.position) - np.asarray(c0.position)
    # view dir at yaw -90, pitch -20: -Z and slightly down
    assert d[2] < 0 and d[1] < 0


def test_movable_light_controls():
    lights = kani.default_lights()
    m = controllers.update_movable_light(
        lights.movable, controllers.LightInputs(forward=1), dt=0.1)
    assert np.asarray(m.position)[2] < -25.0 + 1.0  # IJKL yaw -90 → -Z
    # range steps ±5 within (32, 12800) (reference src/light.rs:229-243)
    m2 = controllers.update_movable_light(
        m, controllers.LightInputs(d_range=1), dt=0.0)
    assert float(m2.range) == float(m.range) + 5.0
    # color steps ±5 per channel
    m3 = controllers.update_movable_light(
        m2, controllers.LightInputs(d_color=1), dt=0.0)
    np.testing.assert_allclose(np.asarray(m3.color),
                               np.asarray(m2.color) + 5.0)


def test_directional_light_rotation_and_distance():
    d = kani.default_lights().directional
    d2 = controllers.rotate_directional_light(d, 4.0, 0.0, 0.0)
    assert not np.allclose(np.asarray(d2.direction), np.asarray(d.direction))
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d2.direction)),
                               np.linalg.norm(np.asarray(d.direction)),
                               rtol=1e-5)
    # Key2/Key3: distance ±10 in [-3000, -100], scene size = |d|*1.5
    d3 = controllers.step_directional_distance(d, +10.0)
    assert float(d3.distance) == -1990.0
    assert float(d3.shadow_scene_size) == 1990.0 * 1.5
    d4 = d
    for _ in range(5):
        d4 = controllers.step_directional_distance(d4, -1e6)
    assert float(d4.distance) == -3000.0


def test_loop_tab_cycles_modes_and_renders():
    events = [
        Events(),                           # frame 0: LIT_SHADOW (initial)
        Events(pressed=frozenset(["tab"])),  # → WIREFRAME
        Events(pressed=frozenset(["tab"])),  # → DEBUG
        Events(pressed=frozenset(["tab"])),  # → UNLIT
    ]
    cfg = kani.RenderConfig(width=64, height=48, shadow_dim=64)
    stats = run_loop(SCENE, events, config=cfg, sink_kind="null")
    assert stats["frames"] == 4
    assert stats["mode"] == "UNLIT"


def test_loop_present_mode_cycle_and_picking():
    events = [
        Events(pressed=frozenset(["f1"])),
        Events(click_pos=(32, 24)),
    ]
    cfg = kani.RenderConfig(width=64, height=48, shadow_dim=64,
                            mode=kani.RenderMode.LIT)
    stats = run_loop(SCENE, events, config=cfg, sink_kind="null")
    assert stats["present_mode"] == "AutoNoVsync"
    assert len(stats["picked"]) == 1
    x, y, raw, linear = stats["picked"][0]
    assert 0.0 <= raw <= 1.0
    # linearized with znear 0.1 / zfar 10000 (reference src/lib.rs:2000-2013);
    # background depth 1.0 linearizes to ~zfar (f32 slack allowed)
    assert 0.1 <= linear <= 10050.0


def test_loop_shadow_table_cache_steady_state():
    """The loop's PCF-table cache (cache_shadow_map=True): the table is
    rendered on the first frame and reused while the sun holds still, and
    every frame matches a fresh-shadow render_frame exactly."""
    from kanirenderer_tpu.passes.frame import render_frame

    captured = []

    class Cap:
        def present(self, f):
            captured.append(np.array(f))

        def close(self):
            pass

    cfg = kani.RenderConfig(width=96, height=64, shadow_dim=64,
                            mode=kani.RenderMode.LIT_SHADOW)
    assert cfg.cache_shadow_map  # the default interactive behavior
    events = [Events(), Events(), Events()]
    run_loop(SCENE, events, config=cfg, sink=Cap())
    assert len(captured) == 3

    # reference: a fresh-shadow frame at the same (static) state
    state = kani.frame_state(SCENE, kani.default_camera(),
                             kani.default_lights())
    ref = render_frame(SCENE, state, cfg.with_(cache_shadow_map=False))
    from kanirenderer_tpu.runtime.display import to_uint8
    ref8 = np.asarray(to_uint8(ref.image))
    for img in captured:
        np.testing.assert_array_equal(img, ref8)


def test_frametime_graph_ring():
    g = FrameTimeGraph()
    for i in range(300):
        g.update(0.01)
    assert g.buffer.shape == (256,)
    np.testing.assert_allclose(g.mean_ms, 10.0, rtol=1e-3)
    assert abs(g.fps - 100.0) < 1.0


def test_gif_sink(tmp_path):
    from kanirenderer_tpu.runtime.display import GifSink
    path = str(tmp_path / "cap.gif")
    s = GifSink(path, fps=10)
    for i in range(3):
        s.present(np.full((8, 8, 3), i * 80, np.uint8))
    s.close()
    import os
    assert os.path.exists(path) and os.path.getsize(path) > 0


def test_file_drop_appends_model(tmp_path):
    from kanirenderer_tpu.io import obj as obj_mod
    from kanirenderer_tpu.io.scene_loader import SceneBuilder
    from kanirenderer_tpu.models.procedural import make_cube_obj

    objpath = tmp_path / "extra.obj"
    objpath.write_text(make_cube_obj(10.0))

    b = SceneBuilder()
    parsed = obj_mod.parse_obj(make_cube_obj(), mtl_loader=lambda p: None)
    b.add_model(parsed, ".", instances=1)
    scene0 = b.build()
    events = [Events(), Events(dropped_file=str(objpath)), Events()]
    cfg = kani.RenderConfig(width=32, height=24, shadow_dim=64,
                            mode=kani.RenderMode.LIT)
    stats = run_loop(scene0, events, config=cfg, sink_kind="null", builder=b)
    assert stats["frames"] == 3
    assert b.build().object_model.shape[0] == 2


def test_animation_random_walk():
    import jax
    from kanirenderer_tpu.models.animation import random_walk_objects
    m0 = SCENE.object_model
    m1, key = random_walk_objects(m0, jax.random.PRNGKey(0), 1.0 / 60.0)
    d = np.abs(np.asarray(m1[:, :3, 3]) - np.asarray(m0[:, :3, 3]))
    assert (d > 0).all() and (d <= 100.0 / 60.0 + 1e-5).all()
    # rotation part untouched
    np.testing.assert_array_equal(np.asarray(m1[:, :3, :3]),
                                  np.asarray(m0[:, :3, :3]))


def test_resize_event_changes_output_size():
    events = [Events(), Events(resize=(48, 32)), Events()]
    frames = []

    class Cap:
        def present(self, f):
            frames.append(f.shape)

        def close(self):
            pass

    from kanirenderer_tpu.runtime import loop as loop_mod
    cfg = kani.RenderConfig(width=32, height=24, shadow_dim=64,
                            mode=kani.RenderMode.LIT)
    import kanirenderer_tpu.runtime.display as disp
    orig = disp.make_sink
    disp.make_sink = lambda *a, **k: Cap()
    loop_mod.make_sink = disp.make_sink
    try:
        run_loop(SCENE, events, config=cfg, sink_kind="null")
    finally:
        disp.make_sink = orig
        loop_mod.make_sink = orig
    assert frames[0] == (24, 32, 3)
    assert frames[1] == (32, 48, 3)


def test_profile_trace_written(tmp_path):
    """--profile / KANI_PROFILE wraps the run in a jax.profiler trace
    (SURVEY §5.1: the deep companion to the frame-time overlay)."""
    import os
    from kanirenderer_tpu import api
    d = tmp_path / "trace"
    api.run("", "opengl", frames=1, sink="null", width=64, height=64,
            verbose=False, profile_dir=str(d))
    found = [f for _, _, fs in os.walk(d) for f in fs]
    assert found, "no profiler trace files written"


def test_render_frame_view_wh_matches_exact_size():
    """Resize-without-recompile framing: rendering into a padded target
    with the view size traced (view_wh) then cropping equals rendering at
    the exact size."""
    from kanirenderer_tpu.passes.frame import render_frame

    state = kani.frame_state(SCENE, kani.default_camera(),
                             kani.default_lights())
    cfg_exact = kani.RenderConfig(width=100, height=70, shadow_dim=64,
                                  mode=kani.RenderMode.LIT)
    cfg_pad = cfg_exact.with_(width=256, height=128)
    out_e = render_frame(SCENE, state, cfg_exact)
    out_p = render_frame(SCENE, state, cfg_pad,
                         view_wh=jnp.asarray([100.0, 70.0], jnp.float32))
    np.testing.assert_allclose(np.asarray(out_p.image)[:70, :100],
                               np.asarray(out_e.image), atol=2e-6)


def test_loop_resize_bucketing_reuses_executables():
    """Drag-resize: several view sizes inside one ladder bucket share ONE
    padded executable (the view size is traced, not static), and each
    presented frame is cropped to its exact view."""
    from kanirenderer_tpu.passes import frame as frame_mod

    shapes = []

    class Cap:
        def present(self, f):
            shapes.append(f.shape)

        def close(self):
            pass

    cfg = kani.RenderConfig(width=64, height=48, shadow_dim=64,
                            mode=kani.RenderMode.LIT)
    events = [
        Events(),                    # 64x48 (initial, unpadded)
        Events(resize=(100, 70)),    # -> bucket 256x256: one compile
        Events(resize=(120, 90)),    # same bucket: reuse
        Events(resize=(200, 150)),   # same bucket: reuse
    ]
    try:
        base = frame_mod.render_frame._cache_size()
    except AttributeError:
        base = None
    stats = run_loop(SCENE, events, config=cfg, sink=Cap())
    assert stats["frames"] == 4
    assert stats["view_size"] == (200, 150)
    assert stats["render_size"] == (256, 256)
    assert shapes == [(48, 64, 3), (70, 100, 3), (90, 120, 3),
                      (150, 200, 3)]
    if base is not None:
        # At most 2 new frame executables (initial size + ONE bucket;
        # earlier tests may have pre-warmed the initial one): the three
        # distinct view sizes share the bucket executable — the claim
        # under test.
        assert frame_mod.render_frame._cache_size() - base <= 2


def test_loop_gives_up_after_persistent_failure(monkeypatch):
    """The OutOfMemory -> exit analog (src/lib.rs:2156): a failing frame
    re-raises instead of looping forever."""
    import pytest
    from kanirenderer_tpu.runtime import loop as loop_mod

    def dead(*a, **k):
        raise RuntimeError("INVALID_ARGUMENT: injected permanent loss")

    monkeypatch.setattr(loop_mod, "render_frame", dead)
    cfg = kani.RenderConfig(width=48, height=32, shadow_dim=64,
                            mode=kani.RenderMode.LIT)
    with pytest.raises(RuntimeError, match="permanent loss"):
        run_loop(SCENE, [Events()] * 10, config=cfg, sink_kind="null")


def test_host_controller_twins_match_jitted():
    """The pure-numpy *_host controller twins (used by the interactive
    loop, which dispatches nothing to the device for them) must match the
    jitted versions bit-for-bit-ish in f32."""
    rng = np.random.RandomState(3)
    for _ in range(20):
        cam = kani.CameraState(
            position=jnp.asarray(rng.randn(3) * 100, jnp.float32),
            yaw=jnp.float32(rng.uniform(-3, 3)),
            pitch=jnp.float32(rng.uniform(-1.4, 1.4)))
        inp = controllers.CameraInputs(
            *[float(x) for x in rng.randint(0, 2, 6)],
            rotate_dx=float(rng.randn() * 5),
            rotate_dy=float(rng.randn() * 5),
            scroll=float(rng.randn()))
        dt = float(rng.uniform(0.001, 0.1))
        a = controllers.update_camera(cam, inp, dt)
        b = controllers.update_camera_host(cam, inp, dt)
        np.testing.assert_allclose(np.asarray(a.position), b.position,
                                   rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(float(a.yaw), b.yaw, atol=1e-6)
        np.testing.assert_allclose(float(a.pitch), b.pitch, atol=1e-6)

        lights = kani.default_lights()
        li = controllers.LightInputs(
            *[float(x) for x in rng.randint(0, 2, 6)],
            d_range=float(rng.randint(-1, 2)),
            d_color=float(rng.randint(-1, 2)))
        a = controllers.update_movable_light(lights.movable, li, dt)
        b = controllers.update_movable_light_host(lights.movable, li, dt)
        np.testing.assert_allclose(np.asarray(a.position), b.position,
                                   rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(np.asarray(a.color), b.color, atol=1e-5)
        np.testing.assert_allclose(float(a.range), b.range, atol=1e-5)

        d = lights.directional
        dx, dy, dz = rng.uniform(-30, 30, 3)
        a = controllers.rotate_directional_light(d, dx, dy, dz)
        b = controllers.rotate_directional_light_host(d, dx, dy, dz)
        np.testing.assert_allclose(np.asarray(a.direction), b.direction,
                                   atol=1e-6)
        a = controllers.step_directional_distance(d, float(rng.choice([-10, 10])))
        # step twin takes the same delta
        delta = float(np.asarray(a.distance) - np.asarray(d.distance))
        b = controllers.step_directional_distance_host(d, delta)
        np.testing.assert_allclose(float(a.distance), b.distance, atol=1e-5)
        np.testing.assert_allclose(float(a.shadow_scene_size),
                                   b.shadow_scene_size, atol=1e-4)


def test_present_preview_native_to_scaling_sink():
    """present_scale + a scaling sink: the loop hands the preview at its
    NATIVE (downsampled) resolution with the view size as the zoom hint —
    no host-side np.repeat upscale (the r4 loop's ~25 ms/frame residual);
    a legacy sink (no scales_preview) still receives full-size frames."""
    calls = []

    class Scaling:
        scales_preview = True

        def present(self, f, view=None):
            calls.append((f.shape, view))

        def close(self):
            pass

    cfg = kani.RenderConfig(width=64, height=48, shadow_dim=64,
                            mode=kani.RenderMode.LIT, present_scale=2)
    stats = run_loop(SCENE, [Events()] * 2, config=cfg, sink=Scaling())
    assert stats["frames"] == 2
    # preview surface is (H/2, W/2); view hint is the full view size
    assert calls == [((24, 32, 3), (64, 48))] * 2

    legacy = []

    class Legacy:
        def present(self, f):
            legacy.append(f.shape)

        def close(self):
            pass

    run_loop(SCENE, [Events()] * 2, config=cfg, sink=Legacy())
    assert legacy == [(48, 64, 3)] * 2


def test_window_sink_scales_preview_to_view():
    """WindowSink's PNG fallback path upscales the native preview to the
    exact view size (nearest), matching the np.repeat legacy output for
    integer-multiple views."""
    from kanirenderer_tpu.runtime import display

    small = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    up = display._scale_to_view(small, (12, 8))
    assert up.shape == (8, 12, 3)
    ref = np.repeat(np.repeat(small, 2, axis=0), 2, axis=1)
    np.testing.assert_array_equal(up, ref)
    # non-multiple view still lands exactly on the requested size
    assert display._scale_to_view(small, (13, 9)).shape == (9, 13, 3)
