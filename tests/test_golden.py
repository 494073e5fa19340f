"""Golden-image regression tests.

Small renders of the cube scene in every mode, compared against stored
goldens (tests/goldens/*.png).  Regenerate intentionally with:
    REGEN_GOLDENS=1 ./scripts/test.sh tests/test_golden.py
Tolerance is loose enough for cross-backend float drift but catches any
real shading/raster change.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

import kanirenderer_tpu as kani
from kanirenderer_tpu.io.image import decode_png, write_png
from kanirenderer_tpu.models.procedural import cube_scene
from kanirenderer_tpu.passes.frame import render_frame

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
REGEN = os.environ.get("REGEN_GOLDENS") == "1"

SCENE = cube_scene()
LIGHTS = kani.default_lights()
CAM = kani.CameraState(
    position=jnp.array([60.0, 45.0, 80.0], jnp.float32),
    yaw=jnp.float32(np.deg2rad(-127.0)),
    pitch=jnp.float32(np.deg2rad(-20.0)))

CASES = [
    ("unlit", dict(mode=kani.RenderMode.UNLIT)),
    ("lit", dict(mode=kani.RenderMode.LIT)),
    ("lit_shadow", dict(mode=kani.RenderMode.LIT_SHADOW)),
    ("lit_shadow_hdr", dict(mode=kani.RenderMode.LIT_SHADOW, hdr=True)),
    ("wireframe", dict(mode=kani.RenderMode.WIREFRAME)),
    ("debug", dict(mode=kani.RenderMode.DEBUG)),
    ("deferred", dict(mode=kani.RenderMode.LIT_SHADOW, deferred=True)),
]


def _render(kw, scene=None, cam=None, width=160, height=120,
            shadow_dim=256) -> np.ndarray:
    scene = SCENE if scene is None else scene
    cfg = kani.RenderConfig(width=width, height=height,
                            shadow_dim=shadow_dim, **kw)
    state = kani.frame_state(scene, cam or CAM, LIGHTS)
    out = render_frame(scene, state, cfg)
    return np.clip(np.asarray(out.image) * 255.0 + 0.5, 0, 255) \
        .astype(np.uint8)


def _check_golden(img, name):
    path = os.path.join(GOLDEN_DIR, f"{name}.png")
    if REGEN:
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        write_png(path, img)
        return
    # A missing golden is a FAILURE, not an invitation to self-create:
    # goldens are only ever (re)generated via an explicit REGEN_GOLDENS=1
    # run that gets reviewed with the diff.
    assert os.path.exists(path), \
        f"no golden for {name}; run REGEN_GOLDENS=1 and review the image"
    golden = decode_png(open(path, "rb").read())
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    # allow a few boundary pixels to flip; no broad drift
    assert (diff > 8).mean() < 0.01, f"{name}: {(diff > 8).mean():.4f}"
    assert diff.mean() < 1.5, f"{name}: mean {diff.mean():.3f}"


@pytest.mark.parametrize("name,kw", CASES)
def test_golden(name, kw):
    _check_golden(_render(kw), f"cube_{name}")


def test_golden_lit_shadow_512():
    """LIT_SHADOW at 512² with a 512² shadow map — large enough that PCF
    penumbra edges span real pixel runs."""
    img = _render(dict(mode=kani.RenderMode.LIT_SHADOW), width=512,
                  height=512, shadow_dim=512)
    _check_golden(img, "cube512_lit_shadow")


def _bricks_scene():
    """Cube textured with the reference's own sponza brick PNGs
    (res/textures/spnza_bricks_a_diff.png + _ddn.png) through the real
    texture load path (V-flip + green-invert for opengl mode)."""
    from kanirenderer_tpu.io.scene_loader import (MaterialTextures,
                                                  SceneBuilder)
    from kanirenderer_tpu.io.image import load_texture_rgba8
    from kanirenderer_tpu.io import obj as obj_mod
    from kanirenderer_tpu.models.procedural import make_cube_obj

    tex_dir = "/root/reference/res/textures"
    diff = load_texture_rgba8(os.path.join(tex_dir, "spnza_bricks_a_diff.png"),
                              is_normal_map=False, opengl_mode=True)
    ddn = load_texture_rgba8(os.path.join(tex_dir, "spnza_bricks_a_ddn.png"),
                             is_normal_map=True, opengl_mode=True)
    parsed = obj_mod.parse_obj(make_cube_obj(), mtl_loader=lambda p: None)
    b = SceneBuilder()
    b.add_model(parsed, tex_dir=".", file_type="opengl", instances=1,
                rng=np.random.RandomState(0))
    b.textures = [MaterialTextures("bricks", diff, ddn)]
    return b.build()


def test_golden_reference_textures():
    if not os.path.exists("/root/reference/res/textures"):
        pytest.skip("reference textures unavailable")
    scene = _bricks_scene()
    img = _render(dict(mode=kani.RenderMode.LIT_SHADOW), scene=scene,
                  width=256, height=192)
    _check_golden(img, "bricks_lit_shadow")


def test_golden_reference_textures_deferred():
    """Deferred pipeline over real reference textures (G-buffer albedo
    quantization + world-space lighting differ from the forward path)."""
    if not os.path.exists("/root/reference/res/textures"):
        pytest.skip("reference textures unavailable")
    scene = _bricks_scene()
    img = _render(dict(mode=kani.RenderMode.LIT_SHADOW, deferred=True),
                  scene=scene, width=256, height=192)
    _check_golden(img, "bricks_deferred")
