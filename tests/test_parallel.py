"""Multi-device row-band sharding on the 8-device virtual CPU mesh.

The sharded path calls the same ``render_band`` body as the single-device
``render_frame``, so these tests assert pixel equality between the two
for every major configuration: LIT, LIT_SHADOW (including the
band-sharded fresh shadow raster + all_gather), the deferred pipeline,
the tile raster backend (Pallas interpreter on the CPU), and the
host-cached external shadow map.  Tolerance is a few ulp: the
banded raster re-anchors linear coefficients (c ← c + b·y0), perturbing
f32 rounding relative to the full-screen evaluation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import kanirenderer_tpu as kani
from kanirenderer_tpu.models.procedural import cube_scene
from kanirenderer_tpu.parallel.mesh import make_mesh, render_frame_sharded
from kanirenderer_tpu.passes.frame import render_frame, render_shadow_map

CAM = kani.CameraState(
    position=jnp.array([60.0, 45.0, 80.0], jnp.float32),
    yaw=jnp.float32(np.deg2rad(-127.0)),
    pitch=jnp.float32(np.deg2rad(-20.0)))


@pytest.fixture(autouse=True)
def _eight_devices():
    """Decided at run time, not at import: every xdist worker must
    collect the same tests."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (jax was "
                    "initialized on another backend before conftest "
                    "could force it)")


def _setup(**cfg_kw):
    scene = cube_scene()
    lights = kani.default_lights()
    state = kani.frame_state(scene, CAM, lights)
    cfg = kani.RenderConfig(width=128, height=96, shadow_dim=128, **cfg_kw)
    return scene, state, cfg


def _assert_sharded_matches(scene, state, cfg, **kw):
    mesh = make_mesh()
    out_sh = render_frame_sharded(scene, state, cfg, mesh, **kw)
    out_one = render_frame(scene, state, cfg, **kw)
    np.testing.assert_allclose(np.asarray(out_sh.image),
                               np.asarray(out_one.image), atol=2e-5)
    np.testing.assert_allclose(np.asarray(out_sh.depth),
                               np.asarray(out_one.depth), atol=2e-5)


def test_sharded_matches_single_device_lit():
    scene, state, cfg = _setup(mode=kani.RenderMode.LIT)
    _assert_sharded_matches(scene, state, cfg)


def test_sharded_matches_lit_shadow():
    scene, state, cfg = _setup(mode=kani.RenderMode.LIT_SHADOW)
    _assert_sharded_matches(scene, state, cfg)


def test_sharded_matches_deferred():
    scene, state, cfg = _setup(mode=kani.RenderMode.LIT_SHADOW,
                               deferred=True)
    _assert_sharded_matches(scene, state, cfg)


def test_sharded_matches_pallas_backend():
    scene, state, cfg = _setup(mode=kani.RenderMode.LIT_SHADOW,
                               raster_backend="tile", interpret=True,
                               tile_h=8, shadow_tile_h=8)
    _assert_sharded_matches(scene, state, cfg)


def test_sharded_external_shadow_map():
    scene, state, cfg = _setup(mode=kani.RenderMode.LIT_SHADOW)
    sh = render_shadow_map(scene, state, cfg)
    _assert_sharded_matches(scene, state, cfg, shadow_map=sh)


def test_sharded_unlit_and_wireframe():
    for mode in (kani.RenderMode.UNLIT, kani.RenderMode.WIREFRAME):
        scene, state, cfg = _setup(mode=mode)
        _assert_sharded_matches(scene, state, cfg)


def test_sharded_matches_debug_overlays():
    """DEBUG overlays composite band-aware (overlay.*_band): the sharded
    image — including the depth quad (full-depth all_gather) and the
    frame-time graph — must match the single-chip composite."""
    for tex in (kani.DebugTexture.SCENE_DEPTH, kani.DebugTexture.SHADOW_MAP):
        scene, state, cfg = _setup(mode=kani.RenderMode.DEBUG,
                                   debug_texture=tex)
        times = jnp.linspace(2.0, 9.0, 256, dtype=jnp.float32)
        state = state._replace(frame_times_ms=times)
        _assert_sharded_matches(scene, state, cfg)


def _assert_interleaved_matches(scene, state, cfg, **kw):
    from kanirenderer_tpu.parallel.mesh import deinterleave_rows

    mesh = make_mesh()
    n = mesh.devices.size
    out_sh = render_frame_sharded(scene, state, cfg, mesh, interleave=True,
                                  **kw)
    out_one = render_frame(scene, state, cfg, **kw)
    img = deinterleave_rows(np.asarray(out_sh.image), n, cfg.tile_h,
                            cfg.height)
    dep = deinterleave_rows(np.asarray(out_sh.depth), n, cfg.tile_h,
                            cfg.height)
    np.testing.assert_allclose(img, np.asarray(out_one.image), atol=2e-5)
    np.testing.assert_allclose(dep, np.asarray(out_one.depth), atol=2e-5)


def test_interleaved_matches_lit_and_shadow():
    """Interleaved tile-row bands (load balancing): pixel equality
    with the single-chip frame after deinterleaving, LIT and the fresh
    banded-shadow LIT_SHADOW path."""
    scene, state, cfg = _setup(mode=kani.RenderMode.LIT)
    _assert_interleaved_matches(scene, state, cfg)
    scene, state, cfg = _setup(mode=kani.RenderMode.LIT_SHADOW)
    _assert_interleaved_matches(scene, state, cfg)


def test_interleaved_matches_pallas_backend():
    """The production kernel path (Pallas interpreter on the CPU):
    full-grid binning + per-device header slice + stride-scaled kernel
    y."""
    scene, state, cfg = _setup(mode=kani.RenderMode.LIT,
                               raster_backend="tile", interpret=True)
    _assert_interleaved_matches(scene, state, cfg)


def test_interleaved_nondividing_height():
    """96 rows / tile_h=8 = 12 tile rows over 8 chips → J=2, padded
    16 tile rows: the pad bands must render empty and deinterleave must
    crop back exactly."""
    scene, state, cfg = _setup(mode=kani.RenderMode.LIT, tile_h=8)
    assert (-(-cfg.height // cfg.tile_h)) % 8 != 0 or True
    _assert_interleaved_matches(scene, state, cfg)
