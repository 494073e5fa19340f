"""Native C++ library parity with the Python implementations."""

import os
import subprocess

import numpy as np
import pytest

from kanirenderer_tpu.io import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ensure_built():
    if native.available():
        return True
    rc = subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                        capture_output=True)
    native._TRIED = False  # re-probe
    return rc.returncode == 0 and native.available()


@pytest.fixture(autouse=True, scope="module")
def _native_lib():
    """Build the library on first use (inside the tests, not at import)."""
    if not _ensure_built():
        pytest.skip("native lib unavailable")


def test_tbn_matches_python():
    from kanirenderer_tpu.io.scene_loader import compute_tbn
    rng = np.random.RandomState(0)
    pos = rng.randn(50, 3).astype(np.float32)
    uv = rng.rand(50, 2).astype(np.float32)
    idx = rng.randint(0, 50, (80, 3)).astype(np.int32)

    nt, nb = native.compute_tbn(pos, uv, idx)

    # reproduce the pure-python path
    import kanirenderer_tpu.io.native as nat
    lib, nat._LIB = nat._LIB, None
    try:
        pt, pb = compute_tbn(pos, uv, idx)
    finally:
        nat._LIB = lib
    np.testing.assert_allclose(nt, pt, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(nb, pb, rtol=1e-4, atol=1e-4)


def test_morton_matches_python():
    from kanirenderer_tpu.io import scene_loader
    rng = np.random.RandomState(1)
    c = rng.randn(500, 3).astype(np.float32)
    no = native.morton_order(c)
    import kanirenderer_tpu.io.native as nat
    lib, nat._LIB = nat._LIB, None
    try:
        po = scene_loader.morton_order(c)
    finally:
        nat._LIB = lib
    np.testing.assert_array_equal(no, po)


def test_obj_parse_matches_python():
    from kanirenderer_tpu.io import obj as obj_mod
    from kanirenderer_tpu.models.procedural import make_cube_obj
    text = make_cube_obj()
    res = native.parse_obj(text)
    assert res is not None
    meshes, names, mtllib = res
    py = obj_mod.parse_obj(text, mtl_loader=lambda p: None)
    assert len(meshes) == len(py.meshes) == 1
    assert mtllib == "none.mtl"
    assert names == ["Material"]
    m, pm = meshes[0], py.meshes[0]
    np.testing.assert_allclose(m["positions"], pm.positions)
    np.testing.assert_allclose(m["texcoords"], pm.texcoords)
    np.testing.assert_allclose(m["normals"], pm.normals)
    np.testing.assert_array_equal(m["indices"], pm.indices)


def test_obj_parse_reference_cube(ref_res):
    with open(f"{ref_res}/cube.obj") as f:
        text = f.read()
    meshes, names, mtllib = native.parse_obj(text)
    assert len(meshes) == 1
    assert meshes[0]["positions"].shape == (24, 3)
    assert meshes[0]["indices"].shape == (12, 3)
    assert mtllib == "cube.mtl"


def test_native_png_roundtrip(tmp_path):
    from kanirenderer_tpu.io.image import decode_png
    img = (np.arange(32 * 48 * 3) % 251).astype(np.uint8).reshape(48, 32, 3)
    path = str(tmp_path / "native.png")
    assert native.write_png(path, img)
    back = decode_png(open(path, "rb").read())
    np.testing.assert_array_equal(img, back)


# ---------------------------------------------------------------------------
# run_kanirenderer C ABI end-to-end: compile the C embedding
# demo against libkani_native.so and drive one headless frame through it —
# the reference's kani-go/main.go:38 flow (cgo → run_kanirenderer → run()).
# ---------------------------------------------------------------------------

def _embed_env():
    import sysconfig
    env = dict(os.environ)
    # CPU backend, renderer package + site-packages visible to the
    # embedded interpreter.
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, sysconfig.get_paths()["purelib"]]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    env.update(KANI_FRAMES="1", KANI_SINK="null",
               KANI_WIDTH="64", KANI_HEIGHT="64")
    return env


@pytest.fixture(scope="module")
def embed_demo(tmp_path_factory):
    out = tmp_path_factory.mktemp("embed") / "embed_demo"
    rc = subprocess.run(
        ["cc", os.path.join(REPO, "examples", "embed_demo.c"),
         "-o", str(out), "-I", os.path.join(REPO, "include"),
         "-L", os.path.join(REPO, "native"), "-lkani_native",
         f"-Wl,-rpath,{os.path.join(REPO, 'native')}"],
        capture_output=True, text=True)
    if rc.returncode != 0:
        pytest.skip(f"cc unavailable/failed: {rc.stderr[:200]}")
    return str(out)


def test_run_kanirenderer_in_process(embed_demo, ref_res):
    cube = f"{ref_res}/cube.obj"
    r = subprocess.run([embed_demo, cube, "opengl", "windowed"],
                       env=_embed_env(), cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "rendered 1 frames" in r.stdout


def test_run_kanirenderer_subprocess_fallback(embed_demo, ref_res):
    cube = f"{ref_res}/cube.obj"
    env = _embed_env()
    env["KANI_EMBED"] = "subprocess"
    r = subprocess.run([embed_demo, cube, "opengl", "windowed"],
                       env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "rendered 1 frames" in r.stdout
