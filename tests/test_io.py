"""IO layer: OBJ/MTL parsing, texture pipeline, scene building."""

import numpy as np
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.io import image, obj
from kanirenderer_tpu.io.scene_loader import SceneBuilder, load_scene
from kanirenderer_tpu.core.types import CHUNK_SIZE

def test_reference_cube_obj(ref_res):
    scene = obj.load_obj(f"{ref_res}/cube.obj")
    assert len(scene.meshes) == 1
    m = scene.meshes[0]
    assert m.positions.shape == (24, 3)   # single-index duplication
    assert m.indices.shape == (12, 3)     # triangulated quads
    assert [mat.name for mat in scene.materials] == ["Material"]
    assert scene.materials[0].diffuse_texture is None


def test_reference_sponza_mtl(ref_res):
    with open(f"{ref_res}/sponza.mtl") as f:
        mats = obj.parse_mtl(f.read())
    assert len(mats) == 25
    named = {m.name: m for m in mats}
    assert any(m.diffuse_texture for m in mats)
    assert any(m.normal_texture for m in mats)
    # texture paths point into res/textures
    texd = [m.diffuse_texture for m in mats if m.diffuse_texture]
    assert all(t.endswith(".png") for t in texd)


def test_texture_opengl_pipeline():
    # V-flip applies to every texture; green inversion to normal maps only
    # (reference src/texture.rs:77-95).
    img = np.zeros((2, 2, 4), np.uint8)
    img[0, 0] = (10, 100, 30, 255)
    import kanirenderer_tpu.io.image as im
    flipped = im.flip_vertical(img)
    assert tuple(flipped[1, 0]) == (10, 100, 30, 255)
    inv = im.invert_green(img)
    assert inv[0, 0, 1] == 155
    # 16-bit inversion
    img16 = np.zeros((1, 1, 3), np.uint16)
    img16[0, 0] = (0, 1000, 0)
    assert im.invert_green(img16)[0, 0, 1] == 64535


def test_default_normal_fallback_on_missing_texture():
    tex = image.load_texture_rgba8("/nope/missing.png", False, True)
    assert tuple(tex[0, 0]) == (128, 128, 255, 255)


def test_scene_padding_and_morton_chunks(ref_res):
    scene = load_scene(f"{ref_res}/cube.obj", file_type="opengl")
    assert scene.num_triangles % CHUNK_SIZE == 0
    valid = np.asarray(scene.tri_valid)
    assert valid.sum() == 12
    assert not valid[12:].any()
    # all valid indices in range
    idx = np.asarray(scene.tri_idx)[valid]
    assert idx.min() >= 0 and idx.max() < scene.num_vertices


def test_untextured_material_uses_default_normal_for_both(ref_res):
    # cube.mtl has no map_Kd/map_Bump → both textures fall back to the
    # default normal map (reference src/resources.rs:105-163).
    scene = load_scene(f"{ref_res}/cube.obj")
    # All-u8 scene → the combined diffuse+normal table; lanes 0:6 of
    # block row 0 = texel (0,0) (dRGB, nRGB) (see ops/sampling.py
    # combined block-window layout); diffuse is sqrt-encoded u8
    # (linear = (v/255)²), normals are raw unorm at source depth (u8 here)
    assert scene.tex_combined.dtype == jnp.uint8
    assert scene.tex_combined.shape[0] > 0
    raw = np.asarray(scene.tex_combined).astype(np.float32)
    drows = (raw[:, 0:3] / 255.0) ** 2
    nrows = raw[:, 3:6] / 255.0
    # diffuse channels (pre-decoded sRGB of 128,128,255)
    from kanirenderer_tpu.io.scene_loader import _srgb_to_linear_np
    expect = _srgb_to_linear_np(np.array([128, 128, 255], np.float32) / 255)
    np.testing.assert_allclose(drows[0, 0:3], expect, atol=4e-3)
    # Fallback textures skip the opengl flip/green-inversion: the reference
    # routes them through Texture::from_bytes, not from_opengl_bytes
    # (src/resources.rs:121 vs 132) — so the raw (128,128,255) remains.
    np.testing.assert_allclose(nrows[0, 0:3],
                               [128 / 255, 128 / 255, 255 / 255], atol=4e-3)


def test_multi_instance_positions(ref_res):
    rng = np.random.RandomState(7)
    scene = load_scene(f"{ref_res}/cube.obj", instances=3, rng=rng)
    models = np.asarray(scene.object_model)
    assert models.shape[0] == 3
    # instance 0 at origin; instance k at (p,p,p) with p in [k, 10k]
    np.testing.assert_allclose(models[0, :3, 3], 0.0)
    for k in (1, 2):
        p = models[k, :3, 3]
        assert p[0] == p[1] == p[2]
        assert k <= p[0] <= 10 * k


def test_builder_appends_models(ref_res):
    # the file-drop flow (reference src/lib.rs:2122-2137): add two models
    b = SceneBuilder()
    parsed = obj.load_obj(f"{ref_res}/cube.obj")
    b.add_model(parsed, ref_res, instances=1)
    b.add_model(parsed, ref_res, instances=1)
    scene = b.build()
    assert np.asarray(scene.tri_valid).sum() == 24
    assert scene.object_model.shape[0] == 2


def test_smol_cube_parses(ref_res):
    scene = obj.load_obj(f"{ref_res}/smol_cube.obj")
    assert len(scene.meshes) >= 1
    assert scene.meshes[0].indices.shape[1] == 3


def test_16bit_normal_map_keeps_source_precision(tmp_path):
    """A 16-bit PNG normal map must survive to the sampler at better than
    8-bit precision (reference src/texture.rs:113-129 picks Rgba16Unorm
    for 16-bit sources)."""
    import jax.numpy as jnp
    from kanirenderer_tpu.ops.sampling import sample_materials_blocks

    # A smooth 16-bit gradient whose values fall BETWEEN 8-bit levels.
    h = w = 24
    g = (np.arange(h * w, dtype=np.uint32).reshape(h, w) * 7 + 129)
    n16 = np.stack([(g % 65536), (g * 3 % 65536),
                    np.full((h, w), 33000)], axis=-1).astype(np.uint16)
    p = tmp_path / "n16.png"
    image.write_png(str(p), n16)

    # OBJ+MTL referencing it as the bump map; a same-size diffuse so the
    # normal map is not resampled to the 4x4 fallback resolution.
    d8 = np.full((h, w, 3), 180, np.uint8)
    image.write_png(str(tmp_path / "d8.png"), d8)
    (tmp_path / "m.mtl").write_text(
        "newmtl m\nmap_Kd d8.png\nmap_Bump n16.png\n")
    (tmp_path / "q.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 0 1\nvn 0 0 1\nvn 0 0 1\nvn 0 0 1\n"
        "usemtl m\nf 1/1/1 2/2/2 3/3/3\n")
    scene = load_scene(str(tmp_path / "q.obj"), file_type="default")
    assert scene.tex_normal.dtype == jnp.uint16

    # Sample texel centers; reconstruction error must beat 8-bit (1/255).
    uu = jnp.asarray([[(3 + 0.5) / w]], jnp.float32)
    vv = jnp.asarray([[(5 + 0.5) / h]], jnp.float32)
    shape = (1, 1)
    _, normal = sample_materials_blocks(
        scene.tex_diffuse, scene.tex_normal,
        jnp.zeros(shape, jnp.int32), scene.mat_blk_w[0] * jnp.ones(shape, jnp.int32),
        w * jnp.ones(shape, jnp.int32), h * jnp.ones(shape, jnp.int32),
        uu, vv)
    got = np.asarray(normal)[:, 0, 0]
    want = n16[5, 3].astype(np.float64) / 65535.0
    err = np.abs(got - want).max()
    assert err < 1e-4, err          # far better than the 8-bit floor
    assert err < (0.5 / 255.0) / 4  # explicitly beats 8-bit quantization
