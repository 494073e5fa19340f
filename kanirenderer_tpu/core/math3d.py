"""3D transform math with cgmath semantics.

The reference renderer (ourbunka/kanirenderer) builds all of its matrices with
the Rust ``cgmath`` crate (reference: src/camera.rs:41-88, src/light.rs:80-119).
This module reproduces those exact semantics as JAX functions so that camera,
projection and light matrices are bit-comparable with the wgpu build:

* ``look_to_rh`` / ``look_at_rh`` — right-handed view matrices.
* ``perspective`` — OpenGL-style projection, NDC z in [-1, 1].  The reference
  deliberately omits the OPENGL_TO_WGPU z correction (src/camera.rs:84-88), so
  we match the *visible* behavior: clip z is consumed directly as depth with a
  [0, w] clip range (see ops/rasterize.py).
* ``ortho`` — symmetric OpenGL ortho cube used by the shadow pass
  (src/light.rs:97-100).

Matrices are stored row-major as (4, 4) arrays acting on column vectors:
``clip = M @ [x, y, z, 1]``.  All functions accept/return float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def normalize(v: Array, axis: int = -1, eps: float = 0.0) -> Array:
    """L2-normalize along ``axis``; matches cgmath's ``.normalize()`` (no eps)."""
    n = jnp.linalg.norm(v, axis=axis, keepdims=True)
    if eps:
        n = jnp.maximum(n, eps)
    return v / n


def cross(a: Array, b: Array) -> Array:
    return jnp.cross(a, b)


def look_to_rh(eye: Array, direction: Array, up: Array) -> Array:
    """Right-handed view matrix looking along ``direction`` from ``eye``.

    cgmath ``Matrix4::look_to_rh`` semantics (used by Camera::calc_matrix,
    reference src/camera.rs:41-54).
    """
    eye = jnp.asarray(eye, jnp.float32)
    f = normalize(jnp.asarray(direction, jnp.float32))
    s = normalize(cross(f, jnp.asarray(up, jnp.float32)))
    u = cross(s, f)
    rot = jnp.stack([s, u, -f])  # rows
    trans = -jnp.matmul(rot, eye, precision=jax.lax.Precision.HIGHEST)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[:3, :3].set(rot)
    m = m.at[:3, 3].set(trans)
    return m


def look_at_rh(eye: Array, center: Array, up: Array) -> Array:
    """cgmath ``Matrix4::look_at_rh`` — used by the directional-light view
    (reference src/light.rs:91-94, note the eye sits at the far target)."""
    eye = jnp.asarray(eye, jnp.float32)
    center = jnp.asarray(center, jnp.float32)
    return look_to_rh(eye, center - eye, up)


def perspective(fovy_rad: float, aspect: float, near: float, far: float) -> Array:
    """cgmath ``perspective(Rad(fovy), aspect, near, far)`` — OpenGL z range.

    Reference: src/camera.rs:84-88 (OPENGL_TO_WGPU correction commented out).
    """
    f = 1.0 / jnp.tan(jnp.asarray(fovy_rad, jnp.float32) / 2.0)
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(f / aspect)
    m = m.at[1, 1].set(f)
    m = m.at[2, 2].set((far + near) / (near - far))
    m = m.at[2, 3].set((2.0 * far * near) / (near - far))
    m = m.at[3, 2].set(-1.0)
    return m


def ortho(left: float, right: float, bottom: float, top: float,
          near: float, far: float) -> Array:
    """cgmath ``ortho`` — OpenGL convention, NDC z in [-1, 1].

    The shadow pass builds a symmetric cube ±shadow_scene_size on all axes
    (reference src/light.rs:97-100).
    """
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(2.0 / (right - left))
    m = m.at[0, 3].set(-(right + left) / (right - left))
    m = m.at[1, 1].set(2.0 / (top - bottom))
    m = m.at[1, 3].set(-(top + bottom) / (top - bottom))
    m = m.at[2, 2].set(-2.0 / (far - near))
    m = m.at[2, 3].set(-(far + near) / (far - near))
    m = m.at[3, 3].set(1.0)
    return m


def rotation_x(rad: Array) -> Array:
    c, s = jnp.cos(rad), jnp.sin(rad)
    m = jnp.zeros((3, 3), jnp.float32)
    return m.at[0, 0].set(1.0).at[1, 1].set(c).at[1, 2].set(-s) \
        .at[2, 1].set(s).at[2, 2].set(c)


def rotation_y(rad: Array) -> Array:
    c, s = jnp.cos(rad), jnp.sin(rad)
    m = jnp.zeros((3, 3), jnp.float32)
    return m.at[0, 0].set(c).at[0, 2].set(s).at[1, 1].set(1.0) \
        .at[2, 0].set(-s).at[2, 2].set(c)


def rotation_z(rad: Array) -> Array:
    c, s = jnp.cos(rad), jnp.sin(rad)
    m = jnp.zeros((3, 3), jnp.float32)
    return m.at[0, 0].set(c).at[0, 1].set(-s).at[1, 0].set(s) \
        .at[1, 1].set(c).at[2, 2].set(1.0)


def rotate_direction_zyx(direction: Array, deg_x: Array, deg_y: Array,
                         deg_z: Array) -> Array:
    """Apply Rz·Ry·Rx (degrees) to a direction vector.

    Matches DirectionalLight::rotate_light (reference src/light.rs:112-119).
    """
    rx = rotation_x(jnp.deg2rad(jnp.asarray(deg_x, jnp.float32)))
    ry = rotation_y(jnp.deg2rad(jnp.asarray(deg_y, jnp.float32)))
    rz = rotation_z(jnp.deg2rad(jnp.asarray(deg_z, jnp.float32)))
    hi = jax.lax.Precision.HIGHEST
    rot = jnp.matmul(jnp.matmul(rz, ry, precision=hi), rx, precision=hi)
    return jnp.matmul(rot, jnp.asarray(direction, jnp.float32), precision=hi)


def quat_to_mat3(q: Array) -> Array:
    """cgmath ``Matrix3::from(Quaternion{v:(x,y,z), s:w})``.

    q is (x, y, z, w).  NOTE: cgmath does NOT normalize — a zero quaternion
    (the reference's default instance rotation, src/resources.rs:277) maps to
    the identity matrix, which we match.
    """
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x2, y2, z2 = x + x, y + y, z + z
    xx2, yy2, zz2 = x * x2, y * y2, z * z2
    xy2, xz2, yz2 = x * y2, x * z2, y * z2
    sx2, sy2, sz2 = w * x2, w * y2, w * z2
    row0 = jnp.stack([1.0 - yy2 - zz2, xy2 - sz2, xz2 + sy2], axis=-1)
    row1 = jnp.stack([xy2 + sz2, 1.0 - xx2 - zz2, yz2 - sx2], axis=-1)
    row2 = jnp.stack([xz2 - sy2, yz2 + sx2, 1.0 - xx2 - yy2], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def instance_to_model_matrix(position: Array, rotation_quat: Array) -> Array:
    """Model matrix = T(position) · R(quat); batched over leading dims.

    Matches Instance::to_raw (reference src/model.rs:271-278).
    """
    rot3 = quat_to_mat3(rotation_quat)
    batch = rot3.shape[:-2]
    m = jnp.zeros(batch + (4, 4), jnp.float32)
    m = m.at[..., :3, :3].set(rot3)
    m = m.at[..., :3, 3].set(position)
    m = m.at[..., 3, 3].set(1.0)
    return m


def camera_forward(yaw: Array, pitch: Array) -> Array:
    """View direction from yaw/pitch (reference src/camera.rs:45-52)."""
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    return normalize(jnp.stack([cp * cy, sp, cp * sy]))


def camera_view_matrix(position: Array, yaw: Array, pitch: Array) -> Array:
    """Camera::calc_matrix (reference src/camera.rs:41-54)."""
    return look_to_rh(position, camera_forward(yaw, pitch),
                      jnp.array([0.0, 1.0, 0.0], jnp.float32))


def directional_light_view_projection(light_direction: Array, distance: Array,
                                      shadow_scene_size: float) -> Array:
    """Light view-projection for the shadow pass.

    Matches generate_directional_light_data (reference src/light.rs:80-110):
    eye at ``light_dir * distance`` looking back at the origin, symmetric
    ortho cube ±shadow_scene_size (including depth).
    """
    d = normalize(jnp.asarray(light_direction, jnp.float32))
    target = d * distance
    view = look_at_rh(target, jnp.zeros(3, jnp.float32),
                      jnp.array([0.0, 1.0, 0.0], jnp.float32))
    s = shadow_scene_size
    proj = ortho(-s, s, -s, s, -s, s)
    return jnp.matmul(proj, view, precision=jax.lax.Precision.HIGHEST)


def transform_points_h(m: Array, pts: Array) -> Array:
    """(4,4) @ [p, 1] for (..., 3) points -> (..., 4) homogeneous output.

    Full-f32 matmul precision: a backend may otherwise run f32 matmuls at
    reduced precision (TF32 on a GPU), which visibly degrades clip
    positions/depth."""
    out = jnp.matmul(pts, m[:, :3].T, precision=jax.lax.Precision.HIGHEST)
    return out + m[:, 3]


def transform_vectors(m3: Array, vecs: Array) -> Array:
    """(3,3) matrix applied to (..., 3) vectors (full f32 precision)."""
    return jnp.matmul(vecs, m3.T, precision=jax.lax.Precision.HIGHEST)
