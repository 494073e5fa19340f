"""Binning correctness + tile-kernel parity with the XLA oracle.

The tile kernel (ops/raster_tiles.py) runs here through the Pallas
interpreter (``RenderConfig.interpret``); on a GPU the same kernel is
compiled by Triton (chip_smoke.py checks it at real widths)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import kanirenderer_tpu as kani
from kanirenderer_tpu.core import math3d
from kanirenderer_tpu.core.types import CHUNK_SIZE, SUBBATCH, SUBS_PER_CHUNK
from kanirenderer_tpu.models.procedural import cube_scene, sponza_standin_scene
from kanirenderer_tpu.ops import binning, raster_tiles, raster_xla
from kanirenderer_tpu.ops.vertex import run_vertex_stage, triangle_setup


def _cfg(**kw):
    """A tile-backend config for the Pallas interpreter."""
    return kani.RenderConfig(raster_backend="tile", interpret=True, **kw)


def _setup_for(scene, cam, cfg, cull=True):
    lights = kani.default_lights()
    proj = math3d.perspective(jnp.deg2rad(cfg.fovy_deg), cfg.aspect,
                              cfg.znear, cfg.zfar)
    view = math3d.camera_view_matrix(cam.position, cam.yaw, cam.pitch)
    lvp = math3d.directional_light_view_projection(
        lights.directional.direction, lights.directional.distance, 3000.0)
    vout = run_vertex_stage(scene, scene.object_model, scene.object_normal,
                            proj @ view, cam.position, lights, lvp)
    return triangle_setup(vout.clip, scene.tri_idx, scene.tri_valid,
                          cfg.width, cfg.height, cull)


def _tile_entries(bins, tile):
    hdr = np.asarray(bins.header)
    first, count = int(hdr[0, tile]), int(hdr[1, tile])
    return np.asarray(bins.stream)[first:first + count]


def _assert_parity(vx, vp, bary=True):
    same = np.asarray(vx.tri) == np.asarray(vp.tri)
    assert (~same).mean() < 0.002, (~same).mean()
    np.testing.assert_allclose(np.asarray(vx.z)[same], np.asarray(vp.z)[same],
                               atol=1e-6)
    if bary:
        np.testing.assert_allclose(np.asarray(vx.bary)[same],
                                   np.asarray(vp.bary)[same], atol=1e-5)


OUTSIDE_CAM = kani.CameraState(
    position=jnp.array([60.0, 45.0, 80.0], jnp.float32),
    yaw=jnp.float32(np.deg2rad(-127.0)),
    pitch=jnp.float32(np.deg2rad(-20.0)))

COURTYARD_CAM = kani.CameraState(
    position=jnp.array([-900.0, 180.0, 0.0], jnp.float32),
    yaw=jnp.float32(0.0), pitch=jnp.float32(np.deg2rad(-5.0)))


def test_binning_covers_all_tiles_with_relevant_chunks():
    """Every tile lists exactly the chunks with a subbatch bbox that
    overlaps it, in ascending chunk order, each with its exact subbatch
    overlap mask."""
    scene = sponza_standin_scene(target_tris=6000, num_materials=4,
                                 tex_size=32)
    cfg = kani.RenderConfig(width=256, height=192)
    st = _setup_for(scene, COURTYARD_CAM, cfg)
    bins = binning.bin_stream(st.bbox, cfg.tiles_x, cfg.tiles_y,
                              cfg.tile_w, cfg.tile_h,
                              cfg.max_tiles_per_chunk, cfg.max_global_chunks)
    assert int(bins.overflow) == 0
    sb = np.asarray(st.bbox).reshape(-1, SUBS_PER_CHUNK, SUBBATCH, 4)
    sx0, sy0 = sb[..., 0].min(-1), sb[..., 1].min(-1)
    sx1, sy1 = sb[..., 2].max(-1), sb[..., 3].max(-1)
    for ty in range(cfg.tiles_y):
        for tx in range(cfg.tiles_x):
            x0, x1 = tx * cfg.tile_w, (tx + 1) * cfg.tile_w
            y0, y1 = ty * cfg.tile_h, (ty + 1) * cfg.tile_h
            hit = (sx0 < x1) & (sx1 > x0) & (sy0 < y1) & (sy1 > y0)
            want = {c: sum(1 << s for s in range(SUBS_PER_CHUNK)
                           if hit[c, s])
                    for c in np.nonzero(hit.any(axis=1))[0]}
            got = _tile_entries(bins, ty * cfg.tiles_x + tx)
            assert list(got[:, 0]) == sorted(want), (ty, tx)
            assert {int(c): int(m) for c, m in got} == want, (ty, tx)


def test_binning_key_above_4096_tiles():
    """The (tile, chunk) key is tile·C + chunk in an int32: grids far
    beyond 4,096 tiles bin correctly at the bench scene's chunk count
    (2,048 chunks), and an unrepresentable grid is refused, not
    wrapped."""
    C = 2048
    assert binning.max_key_tiles(C) > 8 * 4096
    # One small triangle per chunk, chunk c on tile 4c of a 128 × 64 grid
    # of 8 × 8 tiles (8,192 tiles); the chunk's other rows are empty.
    bbox = np.zeros((C * CHUNK_SIZE, 4), np.float32)
    bbox[:, 0:2] = 1024.0            # empty boxes (x1 = y1 = 0)
    tiles_x, tiles_y, tw, th = 128, 64, 8, 8
    for c in range(C):
        t = (c * 4) % (tiles_x * tiles_y)
        x, y = (t % tiles_x) * tw, (t // tiles_x) * th
        bbox[c * CHUNK_SIZE] = [x + 1, y + 1, x + 3, y + 3]
    bins = binning.bin_stream(jnp.asarray(bbox), tiles_x, tiles_y, tw, th,
                              4, 4)
    hdr = np.asarray(bins.header)
    assert int(hdr[1].sum()) == C and int(bins.overflow) == 0
    for c in (0, 1, 1500, C - 1):
        t = (c * 4) % (tiles_x * tiles_y)
        np.testing.assert_array_equal(_tile_entries(bins, t), [[c, 1]])
    with pytest.raises(ValueError, match="int32"):
        binning.bin_stream(jnp.asarray(bbox), 2**16, 2**4, 1, 1, 4, 4)


def test_pallas_matches_xla_cube():
    scene = cube_scene()
    cfg = _cfg(width=256, height=192)
    st = _setup_for(scene, OUTSIDE_CAM, cfg)
    vx = raster_xla.rasterize_xla(st.setup, cfg.width, cfg.height)
    vp = raster_tiles.rasterize(st, cfg)
    _assert_parity(vx, vp)


def test_pallas_matches_xla_standin():
    scene = sponza_standin_scene(target_tris=6000, num_materials=4,
                                 tex_size=32)
    cfg = _cfg(width=256, height=192)
    st = _setup_for(scene, COURTYARD_CAM, cfg)
    vx = raster_xla.rasterize_xla(st.setup, cfg.width, cfg.height)
    vp = raster_tiles.rasterize(st, cfg)
    _assert_parity(vx, vp, bary=False)


def test_pallas_mixed_clipfree_and_crossing_chunks():
    """A chunk of triangles inside the depth range and a chunk of
    near-plane-crossing / beyond-far-plane triangles fighting for the same
    pixels must match the oracle, through the raster and the per-pixel
    record gather."""
    rng = np.random.RandomState(11)
    tris = []
    # chunk 0: CHUNK_SIZE small front-facing triangles, z strictly inside
    # [0, w] at every vertex.
    for _ in range(CHUNK_SIZE):
        cx, cy = rng.uniform(-0.7, 0.7, 2)
        z = rng.uniform(0.3, 0.7)
        s = 0.25
        tris.append([(cx - s, cy - s, z, 1.0), (cx + s, cy - s, z, 1.0),
                     (cx, cy + s, z, 1.0)])
    # chunk 1: triangles with one vertex behind the eye (w < 0) or past
    # the far plane (z > w).
    for i in range(CHUNK_SIZE):
        cx, cy = rng.uniform(-0.5, 0.5, 2)
        if i % 2 == 0:
            tris.append([(cx - 0.3, cy - 0.3, 0.4, 1.0),
                         (cx + 0.3, cy - 0.3, 0.4, 1.0),
                         (cx, cy + 2.0, -0.5, -1.0)])
        else:
            tris.append([(cx - 0.3, cy - 0.3, 0.5, 1.0),
                         (cx + 0.3, cy - 0.3, 0.5, 1.0),
                         (cx, cy + 0.3, 1.5, 1.0)])
    clip_np = np.asarray(tris, np.float32)
    T = len(tris)
    clip = jnp.asarray(clip_np.reshape(T * 3, 4))
    tri_idx = jnp.arange(T * 3, dtype=jnp.int32).reshape(T, 3)
    st = triangle_setup(clip, tri_idx, jnp.ones(T, bool), 256, 192,
                        cull_backfaces=False)
    cfg = _cfg(width=256, height=192)
    vx = raster_xla.rasterize_xla(st.setup, cfg.width, cfg.height)
    vp = raster_tiles.rasterize(st, cfg)
    _assert_parity(vx, vp)
    assert np.isfinite(np.asarray(vp.z)).all()
    # Through the record gather: per-triangle varyings land on the pixels
    # of the winning triangle.
    from kanirenderer_tpu.ops.interpolate import interpolate
    vary = jnp.asarray(np.repeat(np.arange(T, dtype=np.float32), 3)[:, None]
                       * np.ones((1, 24), np.float32))
    pix = interpolate(vp, tri_idx, jnp.zeros(T, jnp.int32), vary,
                      jnp.zeros(1, jnp.int32), jnp.ones(1, jnp.int32),
                      jnp.ones((1, 2), jnp.int32))
    cov = np.asarray(pix.mask)
    np.testing.assert_array_equal(cov, np.asarray(vx.tri) >= 0)
    np.testing.assert_allclose(np.asarray(pix.varyings)[0][cov],
                               np.asarray(vp.tri)[cov], atol=1e-3)


@pytest.mark.parametrize("tile", [(8, 256), (16, 32)])
def test_pallas_tile_w_256_matches_xla(tile):
    """Tile shape must not change the image: parity with the oracle on a
    384-wide frame (the right-edge crop) for a wide and a small tile."""
    scene = sponza_standin_scene(target_tris=6000, num_materials=4,
                                 tex_size=32)
    cfg = _cfg(width=384, height=192, tile_h=tile[0], tile_w=tile[1])
    st = _setup_for(scene, COURTYARD_CAM, cfg)
    vx = raster_xla.rasterize_xla(st.setup, cfg.width, cfg.height)
    vp = raster_tiles.rasterize(st, cfg)
    assert vp.tri.shape == (192, 384)
    _assert_parity(vx, vp)


def test_pallas_wireframe_matches_xla():
    scene = cube_scene()
    cfg = _cfg(width=256, height=192)
    st = _setup_for(scene, OUTSIDE_CAM, cfg, cull=False)
    vx = raster_xla.rasterize_xla(st.setup, cfg.width, cfg.height,
                                  wireframe=True,
                                  wire_thresh=cfg.wire_thresh_px)
    vp = raster_tiles.rasterize(st, cfg, wireframe=True)
    # identical coverage up to float-assoc differences on edge boundaries
    mismatch = (np.asarray(vx.tri) != np.asarray(vp.tri)).mean()
    assert mismatch < 0.002, mismatch


def test_pallas_shadow_depth_matches_xla():
    scene = cube_scene()
    cfg = _cfg(width=128, height=128, shadow_dim=256)
    lights = kani.default_lights()
    lvp = math3d.directional_light_view_projection(
        lights.directional.direction, lights.directional.distance, 3000.0)
    proj = math3d.perspective(jnp.deg2rad(45.0), 1.0, 0.1, 1e4)
    view = math3d.camera_view_matrix(OUTSIDE_CAM.position, OUTSIDE_CAM.yaw,
                                     OUTSIDE_CAM.pitch)
    vout = run_vertex_stage(scene, scene.object_model, scene.object_normal,
                            proj @ view, OUTSIDE_CAM.position, lights, lvp)
    st = triangle_setup(vout.light_clip, scene.tri_idx, scene.tri_valid,
                        cfg.shadow_dim, cfg.shadow_dim, False,
                        depth_bias_constant=2.0, depth_bias_slope=2.0)
    zx = raster_xla.rasterize_depth_xla(st.setup, cfg.shadow_dim)
    zp = raster_tiles.rasterize_depth(st, cfg)
    np.testing.assert_allclose(np.asarray(zx), np.asarray(zp), atol=1e-6)


def test_overflow_diagnostic_counts_dropped_chunks():
    """StreamBins.overflow reports capacity drops (silent truncation would
    make missing geometry untraceable): chunks spanning more tiles than
    max_tiles_per_chunk go to the global list, capped at
    max_global_chunks."""
    # 8 chunks each spanning all 4 tiles of a 2 × 2 grid.
    T = 8 * CHUNK_SIZE
    bbox = jnp.tile(jnp.asarray([[0.0, 0.0, 64.0, 16.0]], jnp.float32),
                    (T, 1))
    bins = binning.bin_stream(bbox, 2, 2, 32, 8, max_tiles_per_chunk=2,
                              max_global_chunks=2)
    assert int(bins.overflow) == 6
    assert int(bins.header[1, 0]) == 2

    # ample caps → no drops
    bins2 = binning.bin_stream(bbox, 2, 2, 32, 8, max_tiles_per_chunk=4,
                               max_global_chunks=2)
    assert int(bins2.overflow) == 0
    np.testing.assert_array_equal(np.asarray(bins2.header[1]), [8] * 4)


def test_overflow_surfaces_through_frame_outputs():
    """Capacity drops propagate raster->PixelBuffer->FrameOutputs so the
    host loop can warn."""
    from kanirenderer_tpu.passes.frame import render_frame

    scene = sponza_standin_scene(target_tris=6000, num_materials=4,
                                 tex_size=32)
    state = kani.frame_state(scene, COURTYARD_CAM, kani.default_lights())
    # Starved capacities force drops.
    cfg = _cfg(width=256, height=192, mode=kani.RenderMode.UNLIT,
               max_tiles_per_chunk=1, max_global_chunks=1)
    out = render_frame(scene, state, cfg)
    assert int(out.raster_overflow) > 0
    # Ample capacities -> zero.
    cfg2 = _cfg(width=256, height=192, mode=kani.RenderMode.UNLIT)
    out2 = render_frame(scene, state, cfg2)
    assert int(out2.raster_overflow) == 0


# ---- layered content ----

def _two_layer_setup(width=256, height=128, nx=16, ny=8):
    """Two screen-covering quad grids at constant NDC depth: a NEAR layer
    (z = 0.2) in front of a FAR layer (z = 0.8).  Enough triangles for
    several chunks per tile; the far layer is fully occluded."""
    verts = []
    tris = []

    def layer(z):
        base = len(verts)
        for j in range(ny + 1):
            for i in range(nx + 1):
                x = -1.0 + 2.0 * i / nx
                y = -1.0 + 2.0 * j / ny
                verts.append((x, y, z, 1.0))
        for j in range(ny):
            for i in range(nx):
                v0 = base + j * (nx + 1) + i
                v1 = v0 + 1
                v2 = v0 + (nx + 1)
                v3 = v2 + 1
                tris.append((v0, v1, v2))
                tris.append((v1, v3, v2))

    layer(0.2)
    layer(0.8)
    T = len(tris)
    pad = (-T) % CHUNK_SIZE
    tris += [(0, 0, 0)] * pad
    clip = jnp.asarray(np.array(verts, np.float32))
    tri_idx = jnp.asarray(np.array(tris, np.int32))
    tri_valid = jnp.asarray(np.array([True] * T + [False] * pad))
    return triangle_setup(clip, tri_idx, tri_valid, width, height,
                          cull_backfaces=False)


def test_occlusion_culling_preserves_output():
    """Fully occluded layers: depth matches the oracle everywhere, in the
    main and the depth-only raster."""
    cfg = _cfg(width=256, height=160)
    st = _two_layer_setup(height=160)
    vx = raster_xla.rasterize_xla(st.setup, cfg.width, cfg.height)
    vp = raster_tiles.rasterize(st, cfg)
    np.testing.assert_allclose(np.asarray(vx.z), np.asarray(vp.z),
                               atol=1e-6)
    same = np.asarray(vx.tri) == np.asarray(vp.tri)
    assert (~same).mean() < 0.02, (~same).mean()
    cfg_d = cfg.with_(shadow_dim=256, shadow_tile_h=16)
    zd = raster_tiles.rasterize_depth(st, cfg_d)
    zx = raster_xla.rasterize_depth_xla(st.setup, cfg_d.shadow_dim)
    np.testing.assert_allclose(np.asarray(zd)[:128], np.asarray(zx)[:128],
                               atol=1e-6)


def test_layered_winners_and_record_gather_match_oracle():
    """Equal-depth ties on the shared edges of constant-z grids resolve
    to the lowest triangle id, as in the oracle; the record gather then
    hands every pixel its winner's varyings."""
    from kanirenderer_tpu.ops.interpolate import interpolate

    cfg = _cfg(width=256, height=224, tile_h=16, tile_w=64)
    st = _two_layer_setup(height=224)
    T = st.setup.shape[0]
    vp = raster_tiles.rasterize(st, cfg)
    vx = raster_xla.rasterize_xla(st.setup, cfg.width, cfg.height)
    np.testing.assert_array_equal(np.asarray(vp.tri), np.asarray(vx.tri))
    vary = jnp.asarray(
        np.linspace(0, 1, T * 24, dtype=np.float32).reshape(T, 24))
    tri_idx = jnp.tile(jnp.arange(T, dtype=jnp.int32)[:, None], (1, 3))
    pix = interpolate(vp, tri_idx, jnp.zeros(T, jnp.int32), vary,
                      jnp.zeros(1, jnp.int32), jnp.ones(1, jnp.int32),
                      jnp.ones((1, 2), jnp.int32))
    w = np.asarray(vx.tri)
    cov = w >= 0
    np.testing.assert_allclose(np.asarray(pix.varyings)[0][cov],
                               np.asarray(vary)[w[cov], 0], atol=1e-6)


def test_interpret_mode_is_never_implicit():
    """Without ``config.interpret`` the kernel is a Triton GPU kernel: it
    lowers to a Triton call for CUDA, and on this CPU it is refused rather
    than silently interpreted."""
    scene = cube_scene()
    cfg = kani.RenderConfig(width=128, height=64, shadow_dim=128,
                            raster_backend="tile", tile_h=16, tile_w=32)
    assert not cfg.interpret
    st = _setup_for(scene, OUTSIDE_CAM, cfg)
    for fn in (lambda s: raster_tiles.rasterize(s, cfg),
               lambda s: raster_tiles.rasterize(s, cfg, wireframe=True),
               lambda s: raster_tiles.rasterize_depth(s, cfg)):
        txt = jax.jit(fn).trace(st).lower(
            lowering_platforms=("cuda",)).as_text()
        assert "__gpu$xla.gpu.triton" in txt
    with pytest.raises(Exception):
        jax.block_until_ready(raster_tiles.rasterize(st, cfg))


def test_tile_sides_must_be_powers_of_two():
    scene = cube_scene()
    cfg = _cfg(width=96, height=64, tile_h=8, tile_w=48)
    st = _setup_for(scene, OUTSIDE_CAM, cfg)
    with pytest.raises(ValueError, match="powers of two"):
        raster_tiles.rasterize(st, cfg)


@pytest.mark.gpu
def test_compiled_kernel_matches_oracle(gpu):
    """The Triton-compiled kernel (no interpreter) against the oracle."""
    scene = sponza_standin_scene(target_tris=6000, num_materials=4,
                                 tex_size=32)
    cfg = kani.RenderConfig(width=384, height=192, shadow_dim=256,
                            raster_backend="tile", tile_h=16, tile_w=32)
    with jax.default_device(gpu):
        st = _setup_for(scene, COURTYARD_CAM, cfg)
        vx = raster_xla.rasterize_xla(st.setup, cfg.width, cfg.height)
        vp = raster_tiles.rasterize(st, cfg)
        _assert_parity(vx, vp)
        np.testing.assert_allclose(
            np.asarray(raster_tiles.rasterize_depth(st, cfg))[:192],
            np.asarray(raster_xla.rasterize_depth_xla(st.setup, 256))[:192],
            atol=1e-6)
