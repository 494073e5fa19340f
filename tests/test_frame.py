"""End-to-end render_frame tests across the five modes (cube scene)."""

import numpy as np
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.models.procedural import cube_scene
from kanirenderer_tpu.passes.frame import render_frame

SCENE = cube_scene()
LIGHTS = kani.default_lights()

OUTSIDE_CAM = kani.CameraState(
    position=jnp.array([60.0, 45.0, 80.0], jnp.float32),
    yaw=jnp.float32(np.deg2rad(-127.0)),
    pitch=jnp.float32(np.deg2rad(-20.0)))

CLEAR_SRGB = np.array([0.349, 0.484, 0.584])  # srgb(0.1, 0.2, 0.3)


def render(mode, camera=OUTSIDE_CAM, hdr=False, **cfgkw):
    cfg = kani.RenderConfig(width=128, height=96, mode=mode, hdr=hdr,
                            shadow_dim=256, **cfgkw)
    state = kani.frame_state(SCENE, camera, LIGHTS)
    return render_frame(SCENE, state, cfg)


def test_modes_render_and_differ():
    images = {}
    for mode in kani.RenderMode:
        out = render(mode)
        img = np.asarray(out.image)
        assert img.shape == (96, 128, 3)
        assert np.isfinite(img).all()
        assert img.min() >= 0.0 and img.max() <= 1.0
        images[mode] = img
    # lit vs unlit vs wireframe produce different pictures
    assert not np.allclose(images[kani.RenderMode.UNLIT],
                           images[kani.RenderMode.LIT])
    assert not np.allclose(images[kani.RenderMode.LIT],
                           images[kani.RenderMode.WIREFRAME])


def test_background_is_clear_color():
    out = render(kani.RenderMode.LIT)
    img = np.asarray(out.image)
    bg = np.asarray(out.depth) >= 1.0
    assert bg.any()
    # LDR surface: sRGB-encoded clear color (0.1, 0.2, 0.3)
    np.testing.assert_allclose(img[bg].mean(axis=0), CLEAR_SRGB, atol=2e-3)


def test_outside_view_covers_plausible_area():
    out = render(kani.RenderMode.LIT)
    cov = (np.asarray(out.depth) < 1.0).mean()
    assert 0.25 < cov < 0.6


def test_inside_view_backface_culled():
    # Default camera sits inside res/cube.obj-scale cube: with wgpu
    # FrontFace::Ccw + cull Back the interior faces are culled.
    out = render(kani.RenderMode.LIT, camera=kani.default_camera())
    assert (np.asarray(out.depth) >= 1.0).all()


def test_wireframe_interior_transparent():
    out = render(kani.RenderMode.WIREFRAME)
    cov = (np.asarray(out.depth) < 1.0).mean()
    assert 0.0 < cov < 0.15  # edges only


def test_hdr_differs_from_ldr():
    ldr = np.asarray(render(kani.RenderMode.LIT_SHADOW, hdr=False).image)
    hdr = np.asarray(render(kani.RenderMode.LIT_SHADOW, hdr=True).image)
    assert not np.allclose(ldr, hdr)


def test_shadow_map_populated_only_when_needed():
    out_lit = render(kani.RenderMode.LIT)
    assert (np.asarray(out_lit.shadow) == 1.0).all()
    out_sh = render(kani.RenderMode.LIT_SHADOW)
    assert (np.asarray(out_sh.shadow) < 1.0).any()


def test_cond_shadow_cache_matches_fresh():
    """The in-executable lax.cond cache path (use_cached_shadow) must
    reproduce the plain fresh-shadow image exactly, both ways."""
    cfg = kani.RenderConfig(width=128, height=96,
                            mode=kani.RenderMode.LIT_SHADOW, shadow_dim=256)
    state = kani.frame_state(SCENE, OUTSIDE_CAM, LIGHTS)
    ref = render_frame(SCENE, state, cfg)

    zeros = jnp.zeros((256, 256), jnp.float32)
    fresh = render_frame(SCENE, state, cfg, zeros, jnp.bool_(False))
    np.testing.assert_array_equal(np.asarray(fresh.image),
                                  np.asarray(ref.image))
    # the fresh frame EMITS the map for the host cache
    np.testing.assert_array_equal(np.asarray(fresh.shadow),
                                  np.asarray(ref.shadow))

    cached = render_frame(SCENE, state, cfg, fresh.shadow, jnp.bool_(True))
    np.testing.assert_array_equal(np.asarray(cached.image),
                                  np.asarray(ref.image))
    # cached frames emit zeros (no input-output aliasing)
    assert (np.asarray(cached.shadow) == 0.0).all()


def test_debug_mode_overlays():
    out = render(kani.RenderMode.DEBUG)
    img = np.asarray(out.image)
    # frame-time graph: a red line exists in the bottom-right region
    region = img[-60:, -100:]
    red = (region[..., 0] > 0.9) & (region[..., 1] < 0.1) & (region[..., 2] < 0.1)
    assert red.any()


def test_movable_light_moves_shading():
    out1 = render(kani.RenderMode.LIT)
    lights2 = LIGHTS._replace(movable=LIGHTS.movable._replace(
        position=jnp.array([200.0, 30.0, 100.0], jnp.float32)))
    state2 = kani.frame_state(SCENE, OUTSIDE_CAM, lights2)
    cfg = kani.RenderConfig(width=128, height=96, mode=kani.RenderMode.LIT,
                            shadow_dim=256)
    out2 = render_frame(SCENE, state2, cfg)
    assert not np.allclose(np.asarray(out1.image), np.asarray(out2.image))


def test_point_light_array_contributes():
    # a real point light near the cube adds light vs the dummy-only rig
    pts = kani.PointLights(
        position=jnp.array([[60.0, 40.0, 60.0]], jnp.float32),
        color=jnp.array([[10.0, 0.0, 0.0]], jnp.float32),
        range=jnp.array([256.0], jnp.float32))
    lights2 = LIGHTS._replace(points=pts)
    state2 = kani.frame_state(SCENE, OUTSIDE_CAM, lights2)
    cfg = kani.RenderConfig(width=128, height=96, mode=kani.RenderMode.LIT,
                            shadow_dim=256)
    out2 = render_frame(SCENE, state2, cfg)
    base = render(kani.RenderMode.LIT)
    d = np.asarray(out2.image) - np.asarray(base.image)
    fg = np.asarray(base.depth) < 1.0
    assert d[fg][:, 0].mean() > 1e-4  # red light adds red


def test_external_shadow_table_matches_fresh():
    """Passing the prebuilt PCF block table (the bench steady-state path,
    which also skips the in-frame table rebuild) must reproduce the
    fresh-shadow image exactly."""
    from kanirenderer_tpu.ops.sampling import build_shadow_table
    cfg = kani.RenderConfig(width=128, height=96,
                            mode=kani.RenderMode.LIT_SHADOW, shadow_dim=256)
    state = kani.frame_state(SCENE, OUTSIDE_CAM, LIGHTS)
    ref = render_frame(SCENE, state, cfg)
    tbl = build_shadow_table(ref.shadow)
    out = render_frame(SCENE, state, cfg, shadow_table=tbl)
    np.testing.assert_array_equal(np.asarray(out.image),
                                  np.asarray(ref.image))
    # external-shadow frames emit a zeros sentinel (no aliasing)
    assert np.asarray(out.shadow).shape == (1, 1)


def test_spawned_point_lights_light_the_scene():
    """The reference's disabled random light spawner made real
    (src/lib.rs:453-512): slot 0 dummy; red lights appear; >=50 adds
    green+blue sets; spawned lights actually contribute shading."""
    from kanirenderer_tpu.core.types import spawn_point_lights
    import numpy as np

    p = spawn_point_lights(5)
    assert p.position.shape == (5, 3)
    np.testing.assert_allclose(np.asarray(p.color[0]), 0.0)  # dummy black
    np.testing.assert_allclose(np.asarray(p.color[1]), [10.0, 0.0, 0.0])
    assert float(p.range[1]) == 256.0

    p50 = spawn_point_lights(50)
    assert p50.position.shape == (150, 3)                    # r+g+b sets
    np.testing.assert_allclose(np.asarray(p50.color[50]), [0.0, 10.0, 0.0])
    np.testing.assert_allclose(np.asarray(p50.color[100]), [0.0, 0.0, 10.0])

    # a light near the cube changes the LIT image vs the dummy-only rig
    cfg = kani.RenderConfig(width=64, height=48, mode=kani.RenderMode.LIT,
                            shadow_dim=128)
    lights = LIGHTS
    base = render_frame(SCENE, kani.frame_state(SCENE, OUTSIDE_CAM, lights),
                        cfg)
    pts = spawn_point_lights(2)
    pts = pts._replace(position=pts.position.at[1].set(
        jnp.asarray([40.0, 60.0, 40.0])))
    lit = render_frame(
        SCENE, kani.frame_state(
            SCENE, OUTSIDE_CAM, lights._replace(points=pts)), cfg)
    assert float(np.abs(np.asarray(lit.image)
                        - np.asarray(base.image)).max()) > 0.01


def test_output_u8_matches_host_quantization():
    """RenderConfig.output_u8 emits the real Rgba8 surface: the on-device
    quantization must equal runtime/display.to_uint8 of the f32 image."""
    from kanirenderer_tpu.runtime.display import to_uint8
    for mode in (kani.RenderMode.LIT, kani.RenderMode.DEBUG):
        f32 = render(mode)
        u8 = render(mode, output_u8=True)
        assert np.asarray(u8.image).dtype == np.uint8
        np.testing.assert_array_equal(np.asarray(u8.image),
                                      to_uint8(f32.image))


def test_output_u8_hdr_is_float16():
    """HDR + output_u8 emits the Rgba16Float surface (f16 linear)."""
    f32 = render(kani.RenderMode.LIT, hdr=True)
    f16 = render(kani.RenderMode.LIT, hdr=True, output_u8=True)
    assert np.asarray(f16.image).dtype == np.float16
    np.testing.assert_allclose(np.asarray(f16.image, np.float32),
                               np.asarray(f32.image), atol=5e-4)


def test_fresh_shadow_geom_cache_matches_inframe():
    """render_shadow_geometry's cached light-space setup/bins must give the
    SAME frame as the in-frame fresh-shadow path (it is the same geometry,
    computed once instead of per frame)."""
    import jax
    from kanirenderer_tpu.passes.frame import render_shadow_geometry
    cfg = kani.RenderConfig(width=128, height=96,
                            mode=kani.RenderMode.LIT_SHADOW,
                            shadow_dim=256, raster_backend="tile",
                            interpret=True)
    state = kani.frame_state(SCENE, OUTSIDE_CAM, LIGHTS)
    geom = jax.tree.map(lambda a: jax.device_put(np.asarray(a)),
                        render_shadow_geometry(SCENE, state, cfg))
    base = render_frame(SCENE, state, cfg)
    cached = render_frame(SCENE, state, cfg, shadow_geom=geom)
    np.testing.assert_array_equal(np.asarray(cached.image),
                                  np.asarray(base.image))
    np.testing.assert_array_equal(np.asarray(cached.shadow),
                                  np.asarray(base.shadow))


def test_present_scale_downsamples_surface_only():
    """RenderConfig.present_scale: the emitted surface is box-downsampled
    on device; render resolution (depth, picking) stays full."""
    import numpy as np
    import jax.numpy as jnp
    import kanirenderer_tpu as kani
    from kanirenderer_tpu.models.procedural import cube_scene
    from kanirenderer_tpu.passes.frame import render_frame

    scene = cube_scene()
    cam = kani.CameraState(
        position=jnp.asarray([60.0, 45.0, 80.0], jnp.float32),
        yaw=jnp.float32(np.deg2rad(-127.0)),
        pitch=jnp.float32(np.deg2rad(-20.0)))
    state = kani.frame_state(scene, cam, kani.default_lights())
    cfg = kani.RenderConfig(width=128, height=96, mode=kani.RenderMode.LIT,
                            output_u8=True)
    full = np.asarray(render_frame(scene, state, cfg).image)
    out2 = render_frame(scene, state, cfg.with_(present_scale=2))
    half = np.asarray(out2.image)
    assert half.shape == (48, 64, 3) and half.dtype == np.uint8
    assert out2.depth.shape == (96, 128)
    ref = full.astype(np.float32).reshape(48, 2, 64, 2, 3).mean((1, 3))
    # u8 quantization commutes within rounding of the box average
    assert np.abs(ref - half.astype(np.float32)).max() <= 1.0


def test_layered_scene_renders_content():
    """The layered scene is actually on screen at the default camera
    (it sizes walls to the frustum at each depth): most pixels covered."""
    from kanirenderer_tpu.models.procedural import layered_scene

    scene = layered_scene(target_tris=4_000)
    st = kani.frame_state(scene, kani.default_camera(), LIGHTS)
    cfg = kani.RenderConfig(width=256, height=128, shadow_dim=64,
                            mode=kani.RenderMode.LIT)
    out = render_frame(scene, st, cfg)
    covered = (np.asarray(out.depth) < 1.0).mean()
    assert covered > 0.95, covered
