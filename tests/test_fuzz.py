"""Robustness fuzz: malformed inputs must never crash the loaders.

The reference tolerates bad assets through fallback chains
(src/resources.rs:51-61, 76-79); these tests feed garbage, truncations,
and pathological-but-valid inputs to the OBJ parser (Python and native
paths) and the image decoders and require graceful behavior."""

import numpy as np
import pytest

from kanirenderer_tpu.io import obj as obj_mod
from kanirenderer_tpu.io.image import load_image_bytes


SEEDS = [
    "v 1 2 3\nf 1 2 3\n",
    "v 1 2 3\nvt 0 0\nvn 0 0 1\nf 1/1/1 1/1/1 1/1/1\n",
    "o name\ng group\nusemtl m\nf 1 2 3\n",
]


def _mutations(rng, text):
    data = text.encode()
    outs = []
    for _ in range(40):
        b = bytearray(data)
        for _ in range(rng.randint(1, 6)):
            op = rng.randint(3)
            if op == 0 and b:
                b[rng.randint(len(b))] = rng.randint(256)
            elif op == 1 and b:
                del b[rng.randint(len(b))]
            else:
                b.insert(rng.randint(len(b) + 1),
                         rng.choice(list(b"0123456789/-. \nfv")))
        outs.append(bytes(b))
    return outs


def test_obj_parser_fuzz_never_crashes():
    """Malformed OBJ text may raise (the error channel that triggers the
    default-cube fallback, reference src/resources.rs:76-79) but must
    never hang or kill the process."""
    rng = np.random.RandomState(42)
    for seed in SEEDS:
        for data in _mutations(rng, seed):
            text = data.decode("utf-8", errors="replace")
            try:
                obj_mod.parse_obj(text, mtl_loader=lambda p: None)
            except Exception:
                pass


def test_corrupt_obj_falls_back_to_default_cube(tmp_path):
    """A file that fails to parse loads as the default cube, like the
    reference's load_model fallback (src/resources.rs:76-79)."""
    from kanirenderer_tpu.api import load_model_or_default
    bad = tmp_path / "bad.obj"
    bad.write_bytes(b"v 1 2 \x14zzz\nf 1 2 3garbage/\xff\n")
    scene, _ = load_model_or_default(str(bad), "opengl")
    assert int(np.asarray(scene.tri_valid).sum()) == 12  # the cube


def test_obj_parser_pathological_valid():
    # out-of-range and negative indices, huge polygon fan, empty faces
    text = "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
    text += "f " + " ".join(str(1 + (i % 3)) for i in range(200)) + "\n"
    text += "f -1 -2 -3\nf 999 1000 1001\n"
    parsed = obj_mod.parse_obj(text, mtl_loader=lambda p: None)
    for m in parsed.meshes:
        assert (np.asarray(m.indices) >= 0).all()


def test_image_decoder_fuzz_never_hangs(tmp_path):
    rng = np.random.RandomState(7)
    png_magic = b"\x89PNG\r\n\x1a\n"
    jpg_magic = b"\xff\xd8\xff\xe0"
    for magic in (png_magic, jpg_magic, b""):
        for _ in range(20):
            blob = magic + bytes(rng.randint(0, 256, rng.randint(4, 300),
                                             dtype=np.uint8))
            try:
                load_image_bytes(blob)
            except Exception:
                pass  # raising is fine; crashing the process is not


def test_native_obj_parser_fuzz():
    from kanirenderer_tpu.io import native
    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.RandomState(11)
    for seed in SEEDS:
        for data in _mutations(rng, seed):
            text = data.decode("utf-8", errors="replace")
            try:
                native.obj_parse(text)
            except Exception:
                pass


def test_occlusion_degenerate_scenes():
    """Tile-kernel edge cases: empty frustum (all triangles behind),
    all-invalid chunks, a single-entry tile — no crash, oracle output."""
    import jax.numpy as jnp
    import kanirenderer_tpu as kani
    from kanirenderer_tpu.core.types import CHUNK_SIZE
    from kanirenderer_tpu.ops import raster_tiles, raster_xla
    from kanirenderer_tpu.ops.vertex import triangle_setup

    cfg = kani.RenderConfig(width=128, height=64, raster_backend="tile",
                            interpret=True)

    def run_case(clip, tris, valid):
        pad = (-len(tris)) % CHUNK_SIZE
        tris = list(tris) + [(0, 0, 0)] * pad
        valid = list(valid) + [False] * pad
        st = triangle_setup(jnp.asarray(clip, jnp.float32),
                            jnp.asarray(tris, jnp.int32),
                            jnp.asarray(valid), cfg.width, cfg.height,
                            cull_backfaces=False)
        vp = raster_tiles.rasterize(st, cfg)
        vx = raster_xla.rasterize_xla(st.setup, cfg.width, cfg.height)
        np.testing.assert_allclose(np.asarray(vp.z), np.asarray(vx.z),
                                   atol=1e-6)

    # all behind the eye plane (w < 0): nothing rasterizes
    run_case([(0.0, 0.0, 0.5, -1.0)] * 3, [(0, 1, 2)], [True])
    # all invalid
    run_case([(0.0, 0.0, 0.5, 1.0)] * 3, [(0, 1, 2)], [False])
    # one tiny triangle (single entry, single subbatch)
    run_case([(-0.1, -0.1, 0.5, 1.0), (0.1, -0.1, 0.5, 1.0),
              (0.0, 0.1, 0.5, 1.0)], [(0, 1, 2)], [True])


def test_resize_fuzz_never_crashes():
    """Random drag-resize sequences (incl. tiny and large sizes) through
    the real loop: every frame presents at the exact view size."""
    import kanirenderer_tpu as kani
    from kanirenderer_tpu.models.procedural import cube_scene
    from kanirenderer_tpu.runtime.loop import Events, run_loop

    rng = np.random.RandomState(5)
    shapes = []

    class Cap:
        def present(self, f):
            shapes.append(f.shape)

        def close(self):
            pass

    sizes = [(int(rng.randint(1, 300)), int(rng.randint(1, 300)))
             for _ in range(4)]
    events = [Events()] + [Events(resize=s) for s in sizes]
    cfg = kani.RenderConfig(width=64, height=48, shadow_dim=64,
                            mode=kani.RenderMode.LIT)
    stats = run_loop(cube_scene(), events, config=cfg, sink=Cap())
    assert stats["frames"] == len(events)
    want = [(48, 64, 3)] + [(h, w, 3) for (w, h) in sizes]
    assert shapes == want
