"""Unit tests for core.math3d against hand-computed cgmath semantics."""

import numpy as np
import jax.numpy as jnp

from kanirenderer_tpu.core import math3d as m3


def np_look_to_rh(eye, direction, up):
    f = direction / np.linalg.norm(direction)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[:3, 3] = -(m[:3, :3] @ eye)
    return m


def test_look_to_rh_matches_cgmath():
    eye = np.array([1.0, 2.0, 3.0], np.float32)
    d = np.array([0.3, -0.4, -1.0], np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    got = np.asarray(m3.look_to_rh(eye, d, up))
    np.testing.assert_allclose(got, np_look_to_rh(eye, d, up), atol=1e-6)


def test_look_to_axis_aligned():
    # Looking down -Z from origin: view == identity.
    got = np.asarray(m3.look_to_rh(np.zeros(3, np.float32),
                                   np.array([0, 0, -1], np.float32),
                                   np.array([0, 1, 0], np.float32)))
    np.testing.assert_allclose(got, np.eye(4), atol=1e-7)


def test_look_at_equals_look_to():
    eye = np.array([5.0, 1.0, -2.0], np.float32)
    center = np.array([0.0, 0.0, 0.0], np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    a = np.asarray(m3.look_at_rh(eye, center, up))
    b = np.asarray(m3.look_to_rh(eye, center - eye, up))
    np.testing.assert_allclose(a, b, atol=1e-7)


def test_perspective_opengl_range():
    fovy = np.deg2rad(45.0)
    p = np.asarray(m3.perspective(fovy, 4 / 3, 0.1, 10000.0))
    f = 1.0 / np.tan(fovy / 2)
    assert np.isclose(p[0, 0], f / (4 / 3))
    assert np.isclose(p[1, 1], f)
    assert np.isclose(p[3, 2], -1.0)
    # A point on the near plane maps to ndc z = -1 (OpenGL convention,
    # reference omits the WGPU correction: src/camera.rs:84-88).
    near_pt = p @ np.array([0, 0, -0.1, 1], np.float32)
    assert np.isclose(near_pt[2] / near_pt[3], -1.0, atol=1e-5)
    far_pt = p @ np.array([0, 0, -10000.0, 1], np.float32)
    assert np.isclose(far_pt[2] / far_pt[3], 1.0, atol=1e-5)


def test_ortho_cube():
    o = np.asarray(m3.ortho(-3000, 3000, -3000, 3000, -3000, 3000))
    # center maps to origin
    np.testing.assert_allclose(o @ np.array([0, 0, 0, 1.0]),
                               [0, 0, 0, 1], atol=1e-7)
    # z_eye = -near(=-(-3000)) ... OpenGL: z_ndc = -z_eye/3000
    p = o @ np.array([0, 0, -1500.0, 1])
    assert np.isclose(p[2], 0.5)


def test_camera_forward_default_pose():
    # yaw -90deg, pitch -20deg (reference src/lib.rs:382): looks toward -Z.
    f = np.asarray(m3.camera_forward(jnp.float32(np.deg2rad(-90)),
                                     jnp.float32(np.deg2rad(-20))))
    assert f[2] < 0 and abs(f[0]) < 1e-6 and f[1] < 0
    np.testing.assert_allclose(np.linalg.norm(f), 1.0, atol=1e-6)


def test_zero_quaternion_is_identity():
    # The reference's default instance rotation is the ZERO quaternion
    # (src/resources.rs:277); cgmath maps it to identity (no normalization).
    q = np.zeros(4, np.float32)
    np.testing.assert_allclose(np.asarray(m3.quat_to_mat3(q)), np.eye(3),
                               atol=1e-7)


def test_quat_to_mat3_rotation():
    # 90 deg about Y: q = (0, sin45, 0, cos45)
    s = np.sin(np.pi / 4)
    q = np.array([0, s, 0, np.cos(np.pi / 4)], np.float32)
    r = np.asarray(m3.quat_to_mat3(q))
    np.testing.assert_allclose(r @ np.array([1, 0, 0]), [0, 0, -1], atol=1e-6)


def test_instance_to_model_matrix_translation():
    m = np.asarray(m3.instance_to_model_matrix(
        np.array([1.0, 2.0, 3.0], np.float32), np.zeros(4, np.float32)))
    expect = np.eye(4); expect[:3, 3] = [1, 2, 3]
    np.testing.assert_allclose(m, expect, atol=1e-7)


def test_rotate_direction_zyx():
    d = np.array([0.0, -1.0, 0.0], np.float32)
    # rotate 90 deg about x: (0,-1,0) -> (0, 0, -1)
    got = np.asarray(m3.rotate_direction_zyx(d, 90.0, 0.0, 0.0))
    np.testing.assert_allclose(got, [0, 0, -1], atol=1e-6)


def test_directional_light_view_projection_origin_depth():
    # Default rig: dir (0,-0.9902682,-0.1391731), distance -2000, size 3000
    # (reference src/light.rs:69-78).  The origin sits 2000 in front of the
    # light eye -> ortho depth = 2000/3000.
    vp = np.asarray(m3.directional_light_view_projection(
        np.array([0.0, -0.9902682, -0.1391731], np.float32),
        jnp.float32(-2000.0), 3000.0))
    clip = vp @ np.array([0, 0, 0, 1.0], np.float32)
    ndc = clip[:3] / clip[3]
    # f32 matrix chain at coordinate scale ~3000 → eps ~ 4e-4
    np.testing.assert_allclose(ndc[:2], [0, 0], atol=2e-3)
    np.testing.assert_allclose(ndc[2], 2000.0 / 3000.0, atol=2e-3)


def test_transform_points_h_batch():
    m = np.asarray(m3.perspective(np.deg2rad(45), 1.0, 0.1, 100.0))
    pts = np.random.RandomState(0).randn(17, 3).astype(np.float32)
    got = np.asarray(m3.transform_points_h(jnp.asarray(m), jnp.asarray(pts)))
    expect = (np.concatenate([pts, np.ones((17, 1), np.float32)], 1) @ m.T)
    # rtol covers accumulation-order drift across XLA flag environments
    np.testing.assert_allclose(got, expect, rtol=3e-5, atol=1e-5)


def _dots_highest(fn, *args):
    """Every dot in ``fn``'s lowering asks for full f32 precision (a GPU
    would otherwise be free to run it in TF32)."""
    import jax
    txt = jax.jit(fn).lower(*args).as_text()
    dots = [ln for ln in txt.splitlines() if "dot_general" in ln]
    assert dots
    return all("HIGHEST" in ln for ln in dots)


def test_rotate_direction_matches_f64():
    rng = np.random.RandomState(4)
    for _ in range(5):
        d = rng.randn(3).astype(np.float32)
        ax, ay, az = rng.uniform(-180, 180, 3)
        got = np.asarray(m3.rotate_direction_zyx(d, ax, ay, az))
        rx, ry, rz = np.deg2rad([ax, ay, az])
        cx, sx, cy, sy, cz, sz = (np.cos(rx), np.sin(rx), np.cos(ry),
                                  np.sin(ry), np.cos(rz), np.sin(rz))
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        want = Rz @ Ry @ Rx @ d.astype(np.float64)
        np.testing.assert_allclose(got, want, atol=2e-6 * np.abs(d).max())
    assert _dots_highest(m3.rotate_direction_zyx,
                         jnp.ones(3, jnp.float32), 10.0, 20.0, 30.0)


def test_transform_vectors_matches_f64():
    rng = np.random.RandomState(5)
    mat = rng.randn(3, 3).astype(np.float32)
    v = (rng.randn(64, 3) * 100).astype(np.float32)
    got = np.asarray(m3.transform_vectors(jnp.asarray(mat),
                                              jnp.asarray(v)))
    want = v.astype(np.float64) @ mat.astype(np.float64).T
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    assert _dots_highest(m3.transform_vectors, jnp.asarray(mat),
                         jnp.asarray(v))
