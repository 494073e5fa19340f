"""Procedural scenes: the test cube and a sponza-scale stand-in.

The reference ships ``res/cube.obj`` (Blender cube, 12 tris, one untextured
material) and benchmarks against ``res/sponza.obj`` (~262K tris, 25
materials) whose geometry is a stripped large blob in the snapshot.  These
generators produce equivalent workloads without file IO:

* ``cube_scene``          — same shape/UV layout class as res/cube.obj.
* ``sponza_standin_scene`` — an architectural scene matched to sponza's
  triangle count, material count and texture sizes, for benchmarking.
"""

from __future__ import annotations

import numpy as np

from kanirenderer_tpu.core.types import CameraState, Scene
from kanirenderer_tpu.io import obj as obj_mod
from kanirenderer_tpu.io.image import default_normal_image
from kanirenderer_tpu.io.scene_loader import MaterialTextures, SceneBuilder


def make_cube_obj(half: float = 25.0) -> str:
    """OBJ text for an axis-aligned cube — one coherently-unwrapped quad per
    face (CCW outward winding, unit-square UVs per face, so the generated
    tangent frames are orthonormal) — the same class of asset as
    res/cube.obj."""
    h = half
    # per-face: (normal, four CCW corners seen from outside)
    faces = [
        ((0, 0, 1), [(-h, -h, h), (h, -h, h), (h, h, h), (-h, h, h)]),
        ((0, 0, -1), [(h, -h, -h), (-h, -h, -h), (-h, h, -h), (h, h, -h)]),
        ((1, 0, 0), [(h, -h, h), (h, -h, -h), (h, h, -h), (h, h, h)]),
        ((-1, 0, 0), [(-h, -h, -h), (-h, -h, h), (-h, h, h), (-h, h, -h)]),
        ((0, 1, 0), [(-h, h, h), (h, h, h), (h, h, -h), (-h, h, -h)]),
        ((0, -1, 0), [(-h, -h, -h), (h, -h, -h), (h, -h, h), (-h, -h, h)]),
    ]
    uvs = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    lines = ["o Cube", "mtllib none.mtl"]
    for _, corners in faces:
        for v in corners:
            lines.append(f"v {v[0]} {v[1]} {v[2]}")
    for n, _ in faces:
        lines.append(f"vn {n[0]} {n[1]} {n[2]}")
    for u in uvs:
        lines.append(f"vt {u[0]} {u[1]}")
    lines.append("usemtl Material")
    for fi in range(6):
        base = fi * 4 + 1
        ids = [(base + k, k + 1, fi + 1) for k in range(4)]
        for tri in ((0, 1, 2), (0, 2, 3)):
            lines.append("f " + " ".join(
                f"{ids[k][0]}/{ids[k][1]}/{ids[k][2]}" for k in tri))
    return "\n".join(lines) + "\n"


def cube_scene(instances: int = 1) -> Scene:
    """A single default cube — reference ``load_default_cube``
    (src/resources.rs:296-303): untextured material → default-normal
    fallback for both diffuse and normal maps."""
    parsed = obj_mod.parse_obj(make_cube_obj(), mtl_loader=lambda p: None)
    b = SceneBuilder()
    b.add_model(parsed, tex_dir=".", file_type="opengl", instances=instances,
                rng=np.random.RandomState(0))
    return b.build()


def _checker_texture(size: int, rgb_a, rgb_b, tiles: int = 8) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    m = ((xx * tiles // size + yy * tiles // size) % 2).astype(bool)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.where(m[..., None], rgb_a, rgb_b)
    img[..., 3] = 255
    return img


def _noise_normal_texture(size: int, rng: np.random.RandomState) -> np.ndarray:
    """A plausible tangent-space normal map with mild bumps."""
    h = rng.standard_normal((size, size)).astype(np.float32)
    # cheap blur for smooth bumps
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0)
             + np.roll(h, 1, 1) + np.roll(h, -1, 1)) / 5.0
    gx = (np.roll(h, -1, 1) - np.roll(h, 1, 1)) * 2.0
    gy = (np.roll(h, -1, 0) - np.roll(h, 1, 0)) * 2.0
    n = np.stack([-gx, -gy, np.ones_like(h)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = ((n * 0.5 + 0.5) * 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def _grid_quads(origin, du, dv, nu, nv, vbase):
    """Subdivided quad patch: returns (positions, uvs, normals, tris)."""
    origin = np.asarray(origin, np.float32)
    du = np.asarray(du, np.float32)
    dv = np.asarray(dv, np.float32)
    us = np.linspace(0.0, 1.0, nu + 1, dtype=np.float32)
    vs = np.linspace(0.0, 1.0, nv + 1, dtype=np.float32)
    P = origin[None, None] + us[None, :, None] * du + vs[:, None, None] * dv
    pos = P.reshape(-1, 3)
    uu, vv = np.meshgrid(us, vs)
    uv = np.stack([uu, vv], -1).reshape(-1, 2) * 4.0  # tile texture 4x
    n = np.cross(du, dv)
    n = n / max(np.linalg.norm(n), 1e-9)
    nrm = np.tile(n[None], (len(pos), 1)).astype(np.float32)
    idx = np.arange((nu + 1) * (nv + 1)).reshape(nv + 1, nu + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    tris = np.concatenate([
        np.stack([a, c, b], -1),
        np.stack([b, c, d], -1),
    ]).astype(np.int32) + vbase
    return pos, uv, nrm, tris


def layered_scene(layers: int = 4, target_tris: int = 260_000,
                  tex_size: int = 256, seed: int = 7) -> Scene:
    """Occlusion-heavy benchmark content: ``layers`` parallel
    screen-filling walls stacked in depth in front of the default camera
    (position (0,5,10) looking −Z, core/types.default_camera), each
    subdivided to ~target_tris/layers triangles.  Everything behind the
    front wall is fully occluded: depth complexity ``layers`` on every
    pixel, where the open courtyard scene has about one."""
    rng = np.random.RandomState(seed)
    b = SceneBuilder()
    for i in range(layers):
        col_a = rng.randint(60, 255, 3)
        col_b = (col_a * 0.5).astype(np.int64)
        b.textures.append(MaterialTextures(
            name=f"layer_{i}",
            diffuse=_checker_texture(tex_size, col_a, col_b, tiles=8),
            normal=_noise_normal_texture(tex_size, rng)))

    per_layer = max(1, target_tris // (2 * layers))
    nu = max(1, int(np.sqrt(per_layer)))
    nv = max(1, per_layer // nu)
    positions, uvs, normals, tris, mats = [], [], [], [], []
    vbase = 0
    for k in range(layers):
        z = -200.0 - 200.0 * k
        # Size each wall to the frustum slab at its depth (fovy 45°,
        # pitch −20° shifts the view center down) with 1.4× margin, so
        # nearly every triangle lands on screen and deeper layers sit
        # fully behind the front wall in every covered pixel.
        dist = 10.0 - z
        hh = dist * np.tan(np.deg2rad(22.5)) * 1.4
        hw = hh * (1920.0 / 1080.0)
        cy = 5.0 - dist * np.tan(np.deg2rad(20.0))
        p, u, n, t = _grid_quads((-hw, cy + hh, z), (2 * hw, 0, 0),
                                 (0, -2 * hh, 0), nu, nv, vbase)
        positions.append(p)
        uvs.append(u)
        normals.append(n)
        tris.append(t)
        mats.append(np.full(len(t), k % layers, np.int32))
        vbase += len(p)

    mesh = obj_mod.ObjMesh(
        name="layered", positions=np.concatenate(positions),
        texcoords=np.concatenate(uvs), normals=np.concatenate(normals),
        indices=np.concatenate(tris), material_id=0)
    from kanirenderer_tpu.io.scene_loader import compute_tbn
    t, bt = compute_tbn(mesh.positions, mesh.texcoords, mesh.indices)
    b.positions.append(mesh.positions)
    b.uvs.append(mesh.texcoords)
    b.normals.append(mesh.normals)
    b.tangents.append(t)
    b.bitangents.append(bt)
    b.vertex_object.append(np.zeros(len(mesh.positions), np.int32))
    b.tri_idx.append(mesh.indices)
    b.tri_mat.append(np.concatenate(mats))
    b.object_transforms.append(
        (np.zeros(3, np.float32), np.zeros(4, np.float32)))
    b._num_objects = 1
    b._vert_base = len(mesh.positions)
    return b.build()


def bench_camera() -> CameraState:
    """The benchmark pose in ``sponza_standin_scene``: inside the courtyard
    at one end, looking down its length."""
    return CameraState(position=np.array([-1000.0, 180.0, 0.0], np.float32),
                       yaw=np.float32(0.0),
                       pitch=np.float32(np.deg2rad(-5.0)))


def sponza_standin_scene(target_tris: int = 262_000, num_materials: int = 25,
                         tex_size: int = 256,
                         seed: int = 0) -> Scene:
    """Architectural benchmark scene matched to sponza's workload:
    ~``target_tris`` triangles, ``num_materials`` textured materials
    (diffuse + normal map each), a big courtyard with floor, walls and
    columns.  Deterministic for reproducible benchmarking."""
    rng = np.random.RandomState(seed)
    b = SceneBuilder()

    # Materials with generated textures.
    for i in range(num_materials):
        col_a = rng.randint(60, 255, 3)
        col_b = (col_a * rng.uniform(0.3, 0.8)).astype(np.int64)
        b.textures.append(MaterialTextures(
            name=f"standin_{i}",
            diffuse=_checker_texture(tex_size, col_a, col_b,
                                     tiles=int(rng.choice([4, 8, 16]))),
            normal=_noise_normal_texture(tex_size, rng),
        ))

    blocks = []   # (origin, du, dv) quads to emit

    S = 1200.0    # courtyard scale (sponza is ~30m at 0.01 scale quirks;
    #               we use the same order of magnitude as camera speeds)
    H = 500.0

    # floor + ceiling
    blocks.append(((-S, 0, -S / 2), (2 * S, 0, 0), (0, 0, S)))
    blocks.append(((-S, H, S / 2), (2 * S, 0, 0), (0, 0, -S)))
    # long walls
    blocks.append(((-S, 0, -S / 2), (0, H, 0), (2 * S, 0, 0)))
    blocks.append(((S, 0, S / 2), (0, H, 0), (-2 * S, 0, 0)))
    # end walls
    blocks.append(((S, 0, -S / 2), (0, H, 0), (0, 0, S)))
    blocks.append(((-S, 0, S / 2), (0, H, 0), (0, 0, -S)))

    # columns: rings of boxes
    ncols = 24
    for k in range(ncols):
        x = -S * 0.85 + (2 * S * 0.85) * (k % (ncols // 2)) / (ncols // 2 - 1)
        z = -S * 0.35 if k < ncols // 2 else S * 0.35
        w = 40.0
        for (o, du, dv) in (
            ((x - w, 0, z - w), (2 * w, 0, 0), (0, H * 0.8, 0)),
            ((x + w, 0, z + w), (-2 * w, 0, 0), (0, H * 0.8, 0)),
            ((x - w, 0, z + w), (0, 0, -2 * w), (0, H * 0.8, 0)),
            ((x + w, 0, z - w), (0, 0, 2 * w), (0, H * 0.8, 0)),
        ):
            blocks.append((o, du, dv))

    # Pick a per-patch subdivision to hit the target triangle count.
    per_patch = max(1, target_tris // (2 * len(blocks)))
    nu = max(1, int(np.sqrt(per_patch)))
    nv = max(1, per_patch // nu)

    positions, uvs, normals, tris, mats = [], [], [], [], []
    vbase = 0
    for i, (o, du, dv) in enumerate(blocks):
        p, u, n, t = _grid_quads(o, du, dv, nu, nv, vbase)
        positions.append(p)
        uvs.append(u)
        normals.append(n)
        tris.append(t)
        mats.append(np.full(len(t), i % num_materials, np.int32))
        vbase += len(p)

    mesh = obj_mod.ObjMesh(
        name="standin",
        positions=np.concatenate(positions),
        texcoords=np.concatenate(uvs),
        normals=np.concatenate(normals),
        indices=np.concatenate(tris),
        material_id=0,
    )
    # Route through SceneBuilder manually to keep per-triangle materials.
    from kanirenderer_tpu.io.scene_loader import compute_tbn
    t, bt = compute_tbn(mesh.positions, mesh.texcoords, mesh.indices)
    b.positions.append(mesh.positions)
    b.uvs.append(mesh.texcoords)
    b.normals.append(mesh.normals)
    b.tangents.append(t)
    b.bitangents.append(bt)
    b.vertex_object.append(np.zeros(len(mesh.positions), np.int32))
    b.tri_idx.append(mesh.indices)
    b.tri_mat.append(np.concatenate(mats))
    b.object_transforms.append(
        (np.zeros(3, np.float32), np.zeros(4, np.float32)))
    b._num_objects = 1
    b._vert_base = len(mesh.positions)
    return b.build()
