"""Test harness: force the CPU backend with 8 virtual devices.

Multi-device sharding paths are validated on a virtual CPU mesh, and the
GPU tile kernel runs through the Pallas interpreter; the compiled GPU
path is exercised by chip_smoke.py on the card.  Tests that need the card
carry the ``gpu`` marker and skip here.
"""

import os
import sys

# CPU unless the caller chose otherwise (the card-only tests run with
# JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# If jax was imported before this conftest ran, the env vars above are too
# late; force the platform through the config API as well (this works as
# long as no computation has executed yet).
import jax  # noqa: E402
import pytest  # noqa: E402

try:
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
except RuntimeError:
    pass

# NOTE: the JAX persistent compilation cache is intentionally NOT enabled —
# on this host the XLA:CPU AOT loader reports machine-feature mismatches on
# reload (SIGILL risk).  Runtime compiles are cheap enough for these tests.


@pytest.fixture
def gpu():
    """The first GPU device; skips where there is none.  Decided inside
    the test, never at import, so every xdist worker collects the same
    tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/ on the card")


@pytest.fixture(scope="session")
def ref_res(tmp_path_factory):
    """A stand-in for the reference's ``res/`` assets, generated in-repo:
    cube.obj + cube.mtl (24 vertices, 12 triangles, one untextured
    material "Material", like the reference's Blender cube), smol_cube.obj,
    and a 25-material sponza.mtl with diffuse and normal textures."""
    from kanirenderer_tpu.io.image import write_png
    from kanirenderer_tpu.models.procedural import (_checker_texture,
                                                    _noise_normal_texture,
                                                    make_cube_obj)
    import numpy as np

    d = tmp_path_factory.mktemp("res")
    (d / "cube.obj").write_text(
        make_cube_obj().replace("mtllib none.mtl", "mtllib cube.mtl"))
    (d / "cube.mtl").write_text(
        "newmtl Material\nNs 250\nKa 1 1 1\nKd 0.8 0.8 0.8\n"
        "Ks 0.5 0.5 0.5\nd 1\nillum 2\n")
    (d / "smol_cube.obj").write_text(
        make_cube_obj(half=1.0).replace("mtllib none.mtl",
                                        "mtllib cube.mtl"))
    tex = d / "textures"
    tex.mkdir()
    rng = np.random.RandomState(0)
    lines = []
    for i in range(25):
        lines += [f"newmtl sponza_{i:02d}", "Kd 0.8 0.8 0.8"]
        if i % 5 != 4:
            write_png(str(tex / f"m{i:02d}_diff.png"),
                      _checker_texture(8, (200, 40, 40), (40, 40, 200)))
            lines.append(f"map_Kd textures/m{i:02d}_diff.png")
        if i % 2 == 0:
            write_png(str(tex / f"m{i:02d}_ddn.png"),
                      _noise_normal_texture(8, rng))
            lines.append(f"map_Bump textures/m{i:02d}_ddn.png")
        lines.append("")
    (d / "sponza.mtl").write_text("\n".join(lines))
    return str(d)
