"""Input controllers as pure state-transition functions.

The reference's CameraController / MovableLightController mutate state from
winit events each frame (reference src/camera.rs:90-198,
src/light.rs:172-283).  Here the *pressed-key set* is host state and the
per-frame integration is pure: ``update(state, inputs, dt) -> state`` — so
the controllers compose with jit and are unit-testable as math.

Bindings (reference src/main.rs:11-17 banner + src/lib.rs:1208-1379):
  camera: WASD/arrows planar, Space/LShift vertical, mouse look (RMB held),
          scroll zoom along the view direction;
  movable light: IJKL planar, U/O vertical, =/- range, [/] color;
  directional light: R/T/Y rotate 4° about x/y/z, Key2/Key3 distance ±10;
  Tab render mode, Key1 debug texture, F1 present mode, F11 fullscreen.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as _np

from kanirenderer_tpu.core import math3d
from kanirenderer_tpu.core.types import (CameraState, DirectionalLight,
                                         MovableLight)

Array = jnp.ndarray

SAFE_PITCH = 1.5707964 - 1e-4  # FRAC_PI_2 - 0.0001 (reference src/camera.rs:15)

CAMERA_SPEED = 300.0        # reference src/lib.rs:386
CAMERA_SENSITIVITY = 0.4
LIGHT_SPEED = 300.0         # reference src/lib.rs:445
LIGHT_SENSITIVITY = 1.0


class CameraInputs(NamedTuple):
    """Per-frame input amounts (1.0 while key held, mouse deltas in px)."""

    forward: float = 0.0
    backward: float = 0.0
    left: float = 0.0
    right: float = 0.0
    up: float = 0.0
    down: float = 0.0
    rotate_dx: float = 0.0
    rotate_dy: float = 0.0
    scroll: float = 0.0


class LightInputs(NamedTuple):
    forward: float = 0.0
    backward: float = 0.0
    left: float = 0.0
    right: float = 0.0
    up: float = 0.0
    down: float = 0.0
    d_range: float = 0.0   # ±5 steps applied on key press
    d_color: float = 0.0   # ±5 per channel on key press


@partial(jax.jit, static_argnames=("speed", "sensitivity"))
def update_camera(cam: CameraState, inp: CameraInputs, dt: float,
                  speed: float = CAMERA_SPEED,
                  sensitivity: float = CAMERA_SENSITIVITY) -> CameraState:
    """Reference CameraController::update_camera (src/camera.rs:170-197):
    yaw-basis planar movement, scroll along the pitched view direction,
    mouse-delta yaw/pitch with pitch clamped to ±(π/2 − 1e-4)."""
    dt = jnp.float32(dt)
    yaw_sin = jnp.sin(cam.yaw)
    yaw_cos = jnp.cos(cam.yaw)
    forward = jnp.stack([yaw_cos, jnp.float32(0.0), yaw_sin])
    right = jnp.stack([-yaw_sin, jnp.float32(0.0), yaw_cos])
    pos = cam.position
    pos = pos + forward * (inp.forward - inp.backward) * speed * dt
    pos = pos + right * (inp.right - inp.left) * speed * dt

    pitch_sin = jnp.sin(cam.pitch)
    pitch_cos = jnp.cos(cam.pitch)
    scrollward = math3d.normalize(jnp.stack(
        [pitch_cos * yaw_cos, pitch_sin, pitch_cos * yaw_sin]))
    pos = pos + scrollward * inp.scroll * speed * sensitivity * dt
    pos = pos.at[1].add((inp.up - inp.down) * speed * dt)

    yaw = cam.yaw + inp.rotate_dx * sensitivity * dt
    pitch = cam.pitch + (-inp.rotate_dy) * sensitivity * dt
    pitch = jnp.clip(pitch, -SAFE_PITCH, SAFE_PITCH)
    return CameraState(position=pos, yaw=yaw, pitch=pitch)


@partial(jax.jit, static_argnames=("speed",))
def update_movable_light(light: MovableLight, inp: LightInputs, dt: float,
                         speed: float = LIGHT_SPEED) -> MovableLight:
    """Reference MovableLightController::update_light (src/light.rs:263-282)
    plus the range/color key steps (src/light.rs:229-258): range ±5 within
    (32, 12800), color ∓5 per channel within (1e-5, 10000)."""
    dt = jnp.float32(dt)
    yaw_sin = jnp.sin(light.yaw)
    yaw_cos = jnp.cos(light.yaw)
    forward = jnp.stack([yaw_cos, jnp.float32(0.0), yaw_sin])
    right = jnp.stack([-yaw_sin, jnp.float32(0.0), yaw_cos])
    pos = light.position
    pos = pos + forward * (inp.forward - inp.backward) * speed * dt
    pos = pos + right * (inp.right - inp.left) * speed * dt
    pos = pos.at[1].add((inp.up - inp.down) * speed * dt)

    # Key steps replicate the reference's guard-then-step quirk: the guard
    # tests the bound but the step applies regardless of direction.
    rng = light.range
    rng = jnp.where((inp.d_range > 0) & (rng > 32.0), rng + 5.0, rng)
    rng = jnp.where((inp.d_range < 0) & (rng < 12800.0), rng - 5.0, rng)
    col = light.color
    col = jnp.where((inp.d_color < 0) & (col[0] > 1e-5), col - 5.0, col)
    col = jnp.where((inp.d_color > 0) & (col[0] < 10000.0), col + 5.0, col)
    return MovableLight(position=pos, color=col, range=rng, yaw=light.yaw)


def rotate_directional_light(d: DirectionalLight, deg_x: float, deg_y: float,
                             deg_z: float) -> DirectionalLight:
    """R/T/Y keys: rotate the sun 4° about x/y/z
    (reference src/lib.rs:1341-1355 → src/light.rs:112-119)."""
    new_dir = math3d.rotate_direction_zyx(d.direction, deg_x, deg_y, deg_z)
    return d._replace(direction=new_dir)


def step_directional_distance(d: DirectionalLight,
                              delta: float) -> DirectionalLight:
    """Key2/Key3: distance ±10 clamped to [-3000, -100], with
    shadow_scene_size = |distance| * 1.5 (reference src/lib.rs:1329-1340)."""
    dist = jnp.clip(d.distance + delta, -3000.0, -100.0)
    return d._replace(distance=dist,
                      shadow_scene_size=jnp.abs(dist) * 1.5)


# ---- pure-numpy host twins ----
#
# The reference's controllers are host code (src/lib.rs:1382-1705); the
# interactive loop uses these numpy twins so that a frame's scalar state
# update costs no device dispatch or fetch.  They feed the frame
# executable directly; equivalence with the
# jitted versions above is pinned by
# tests/test_runtime.py::test_host_controller_twins.  All math in f32 to
# match the jax versions' rounding.

def _f32(x):
    return _np.float32(x)


def update_camera_host(cam: CameraState, inp: CameraInputs, dt: float,
                       speed: float = CAMERA_SPEED,
                       sensitivity: float = CAMERA_SENSITIVITY
                       ) -> CameraState:
    dt = _f32(dt)
    speed = _f32(speed)
    sensitivity = _f32(sensitivity)
    yaw = _f32(cam.yaw)
    pitch = _f32(cam.pitch)
    yaw_sin, yaw_cos = _np.sin(yaw), _np.cos(yaw)
    forward = _np.array([yaw_cos, 0.0, yaw_sin], _np.float32)
    right = _np.array([-yaw_sin, 0.0, yaw_cos], _np.float32)
    pos = _np.asarray(cam.position, _np.float32).copy()
    pos += forward * (_f32(inp.forward) - _f32(inp.backward)) * speed * dt
    pos += right * (_f32(inp.right) - _f32(inp.left)) * speed * dt

    pitch_sin, pitch_cos = _np.sin(pitch), _np.cos(pitch)
    sv = _np.array([pitch_cos * yaw_cos, pitch_sin, pitch_cos * yaw_sin],
                   _np.float32)
    sv = sv / _np.linalg.norm(sv).astype(_np.float32)
    pos += sv.astype(_np.float32) * _f32(inp.scroll) * speed \
        * sensitivity * dt
    pos[1] += (_f32(inp.up) - _f32(inp.down)) * speed * dt

    yaw = yaw + _f32(inp.rotate_dx) * sensitivity * dt
    pitch = pitch + (-_f32(inp.rotate_dy)) * sensitivity * dt
    pitch = _np.clip(pitch, _f32(-SAFE_PITCH), _f32(SAFE_PITCH))
    return CameraState(position=pos.astype(_np.float32),
                       yaw=_f32(yaw), pitch=_f32(pitch))


def update_movable_light_host(light: MovableLight, inp: LightInputs,
                              dt: float,
                              speed: float = LIGHT_SPEED) -> MovableLight:
    dt = _f32(dt)
    speed = _f32(speed)
    yaw = _f32(light.yaw)
    yaw_sin, yaw_cos = _np.sin(yaw), _np.cos(yaw)
    forward = _np.array([yaw_cos, 0.0, yaw_sin], _np.float32)
    right = _np.array([-yaw_sin, 0.0, yaw_cos], _np.float32)
    pos = _np.asarray(light.position, _np.float32).copy()
    pos += forward * (_f32(inp.forward) - _f32(inp.backward)) * speed * dt
    pos += right * (_f32(inp.right) - _f32(inp.left)) * speed * dt
    pos[1] += (_f32(inp.up) - _f32(inp.down)) * speed * dt

    rng = _f32(light.range)
    if inp.d_range > 0 and rng > 32.0:
        rng = rng + _f32(5.0)
    if inp.d_range < 0 and rng < 12800.0:
        rng = rng - _f32(5.0)
    col = _np.asarray(light.color, _np.float32).copy()
    if inp.d_color < 0 and col[0] > 1e-5:
        col = col - _f32(5.0)
    if inp.d_color > 0 and col[0] < 10000.0:
        col = col + _f32(5.0)
    return MovableLight(position=pos.astype(_np.float32),
                        color=col.astype(_np.float32), range=rng,
                        yaw=yaw)


def _rot_mats_host(deg_x, deg_y, deg_z):
    out = []
    for deg, axes in ((deg_x, (1, 2)), (deg_y, (2, 0)), (deg_z, (0, 1))):
        a = _np.deg2rad(_f32(deg)).astype(_np.float32)
        c, s = _np.cos(a), _np.sin(a)
        m = _np.eye(3, dtype=_np.float32)
        i, j = axes
        m[i, i] = c
        m[i, j] = -s
        m[j, i] = s
        m[j, j] = c
        out.append(m)
    return out  # [Rx, Ry, Rz]


def rotate_directional_light_host(d: DirectionalLight, deg_x: float,
                                  deg_y: float, deg_z: float
                                  ) -> DirectionalLight:
    rx, ry, rz = _rot_mats_host(deg_x, deg_y, deg_z)
    new_dir = (rz @ ry @ rx) @ _np.asarray(d.direction, _np.float32)
    return d._replace(direction=new_dir.astype(_np.float32))


def step_directional_distance_host(d: DirectionalLight,
                                   delta: float) -> DirectionalLight:
    dist = _np.clip(_f32(d.distance) + _f32(delta), -3000.0, -100.0) \
        .astype(_np.float32)
    return d._replace(distance=dist,
                      shadow_scene_size=_np.abs(dist) * _f32(1.5))
