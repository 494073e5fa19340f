"""Per-frame vertex stage and triangle setup (dense XLA, component-planar).

Replaces the WGSL vertex shaders (reference src/shader.wgsl:77-116) with one
batched pass over all scene vertices:

* world transform by per-object model/normal matrices;
* clip position ``view_proj @ world_pos``;
* the varying set the fragment stage consumes — tangent-space fragment
  position, the (transposed) TBN rows, world position and UV — packed
  into a (V, NV) matrix so the shading pass gathers ONE row per corner
  per pixel.

The reference vertex shader also emits tangent_view_position,
tangent_light_position (src/shader.wgsl:106-112) and shadow_coord
(src/shader.wgsl:113-114).  Those are affine images of quantities that
are already interpolated — TBN·const_point and lvp·world_position — and
barycentric interpolation commutes with affine maps exactly, so the
fragment stage (shade/forward.py) derives them per pixel instead.  That
keeps 9 lanes out of the per-pixel record gather with identical results.

All math runs on component planes ((V,)/(T,) vectors) instead of (N, 3)
rows: arrays are transposed once at the boundaries and assembled once at
the end.

Triangle setup implements homogeneous 2D rasterization (Olano-Greer style):
edge functions are built directly from clip-space coordinates via the
adjugate of the 3x3 homogeneous screen matrix, so near-plane clipping is
never needed — external triangles (some w <= 0) rasterize correctly.
This replaces the hardware clipper+rasterizer fixed function, which JAX
cannot reach.

Varying layout (NV = 24 lanes):
  0:3   tangent_position       (TBN rows · world_pos)
  3:6   TBN row t (world tangent)
  6:9   TBN row b (world bitangent)
  9:12  TBN row n (world normal)
  12:15 world_position
  15:17 uv
  17:24 (padding)

Triangle-setup layout (16 lanes):
  0:3  e0 (a, b, c) edge function   l0(p) = a*x + b*y + c
  3:6  e1
  6:9  e2                (sign-normalized: inside => all l_i >= 0)
  9:12 zrow   z(p) = zrow · (x, y, 1)   (screen-AFFINE NDC depth — the
       adjugate construction makes the interpolated w constant per
       triangle, see _setup_from_corner_planes; depth clip = z ∈ [0, 1])
  12:15 unused (zero; was the w interpolant before the affine-z collapse)
  15   valid flag (1.0 = rasterize)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from kanirenderer_tpu.core.types import Lights, Scene

Array = jnp.ndarray

NV = 24  # varying lanes per vertex
NS = 16  # setup lanes per triangle


class VertexOutputs(NamedTuple):
    clip: Array        # (V, 4) camera-clip positions
    varyings: Array    # (V, NV)
    light_clip: Array  # (V, 4) directional-light clip positions (shadow pass)


def _norm_planes(x, y, z):
    inv = jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, 1e-30))
    return x * inv, y * inv, z * inv


def run_vertex_stage(scene: Scene, object_model: Array, object_normal: Array,
                     view_proj: Array, camera_pos: Array, lights: Lights,
                     light_view_proj: Array) -> VertexOutputs:
    """All per-vertex work for one frame (≈ vs_main of every forward shader,
    reference src/shader.wgsl:77-116)."""
    O = object_model.shape[0]
    # per-vertex matrix rows, gathered once and transposed to planes
    mm = jnp.take(object_model.reshape(O, 16), scene.vertex_object,
                  axis=0).T                       # (16, V)
    nm = jnp.take(object_normal.reshape(O, 9), scene.vertex_object,
                  axis=0).T                       # (9, V)

    pos = scene.position.T                        # (3, V)
    px, py, pz = pos[0], pos[1], pos[2]

    wx = mm[0] * px + mm[1] * py + mm[2] * pz + mm[3]
    wy = mm[4] * px + mm[5] * py + mm[6] * pz + mm[7]
    wz = mm[8] * px + mm[9] * py + mm[10] * pz + mm[11]

    def nmul(v):  # (3, V) object-space vectors → normalized world planes
        a = nm[0] * v[0] + nm[1] * v[1] + nm[2] * v[2]
        b = nm[3] * v[0] + nm[4] * v[1] + nm[5] * v[2]
        c = nm[6] * v[0] + nm[7] * v[1] + nm[8] * v[2]
        return _norm_planes(a, b, c)

    tx, ty, tz = nmul(scene.tangent.T)
    bx, by, bz = nmul(scene.bitangent.T)
    nx, ny, nz = nmul(scene.normal.T)

    def mat_apply(m):  # (4,4) @ [w, 1] for world planes → 4 planes
        return [m[i, 0] * wx + m[i, 1] * wy + m[i, 2] * wz + m[i, 3]
                for i in range(4)]

    cx, cy, cz, cw = mat_apply(view_proj)
    lx, ly, lz, lw = mat_apply(light_view_proj)

    def tbn_dot(vx2, vy2, vz2):
        return (tx * vx2 + ty * vy2 + tz * vz2,
                bx * vx2 + by * vy2 + bz * vz2,
                nx * vx2 + ny * vy2 + nz * vz2)

    tp0, tp1, tp2 = tbn_dot(wx, wy, wz)

    uv = scene.uv.T
    zero = jnp.zeros_like(wx)
    varyings = jnp.stack(
        [tp0, tp1, tp2,
         tx, ty, tz, bx, by, bz, nx, ny, nz,
         wx, wy, wz, uv[0], uv[1]]
        + [zero] * (NV - 17), axis=1)             # (V, NV)
    clip = jnp.stack([cx, cy, cz, cw], axis=1)
    light_clip = jnp.stack([lx, ly, lz, lw], axis=1)
    return VertexOutputs(clip=clip, varyings=varyings, light_clip=light_clip)


class CornerOutputs(NamedTuple):
    """Corner-major vertex-stage outputs: tuples of planar (T,) arrays.

    ``clip``/``light_clip``: 3 corners × (x, y, z, w); ``varyings``:
    3 corners × USED-plane tuples in the layout above.  Feeding
    triangle_setup_corners / records assembly directly, these replace the
    per-frame corner row gathers (clip: 3T rows, varyings: 3 × T rows) of
    the vertex-major path — the gather pattern (tri_idx) is static, so
    the scene stores corner-expanded attributes and the vertex math runs
    over triangles' corners instead of shared vertices.  Identical
    results: the math per (vertex, triangle) instance is the same.
    """
    clip: tuple
    varyings: tuple
    light_clip: tuple


def run_vertex_stage_corners(scene, object_model: Array,
                             object_normal: Array, view_proj: Array,
                             camera_pos: Array, lights,
                             light_view_proj: Array) -> CornerOutputs:
    """Corner-major ``run_vertex_stage`` over Scene.corner_* planes.

    One (T,)-row gather of the per-TRIANGLE object matrices (a triangle
    belongs to exactly one object) replaces the per-vertex matrix gather;
    everything downstream is pure planar math — no row gathers anywhere
    between here and the raster kernel.
    """
    O = object_model.shape[0]
    mm = jnp.take(object_model.reshape(O, 16), scene.tri_object,
                  axis=0).T                     # (16, T)
    nm = jnp.take(object_normal.reshape(O, 9), scene.tri_object,
                  axis=0).T                     # (9, T)

    def nmul(v0, v1, v2):
        a = nm[0] * v0 + nm[1] * v1 + nm[2] * v2
        b = nm[3] * v0 + nm[4] * v1 + nm[5] * v2
        c = nm[6] * v0 + nm[7] * v1 + nm[8] * v2
        return _norm_planes(a, b, c)

    clip, light_clip, varyings = [], [], []
    for k in range(3):
        px, py, pz = (scene.corner_pos[3 * k + i] for i in range(3))
        wx = mm[0] * px + mm[1] * py + mm[2] * pz + mm[3]
        wy = mm[4] * px + mm[5] * py + mm[6] * pz + mm[7]
        wz = mm[8] * px + mm[9] * py + mm[10] * pz + mm[11]

        tx, ty, tz = nmul(*(scene.corner_tangent[3 * k + i]
                            for i in range(3)))
        bx, by, bz = nmul(*(scene.corner_bitangent[3 * k + i]
                            for i in range(3)))
        nx, ny, nz = nmul(*(scene.corner_normal[3 * k + i]
                            for i in range(3)))

        def mat_apply(m):
            return tuple(m[i, 0] * wx + m[i, 1] * wy + m[i, 2] * wz
                         + m[i, 3] for i in range(4))

        clip.append(mat_apply(view_proj))
        light_clip.append(mat_apply(light_view_proj))

        tp0 = tx * wx + ty * wy + tz * wz
        tp1 = bx * wx + by * wy + bz * wz
        tp2 = nx * wx + ny * wy + nz * wz
        varyings.append((tp0, tp1, tp2,
                         tx, ty, tz, bx, by, bz, nx, ny, nz,
                         wx, wy, wz,
                         scene.corner_uv[2 * k], scene.corner_uv[2 * k + 1]))
    return CornerOutputs(clip=tuple(clip), varyings=tuple(varyings),
                         light_clip=tuple(light_clip))


class TriangleSetup(NamedTuple):
    setup: Array   # (T, NS) f32
    bbox: Array    # (T, 4) f32 — (x0, y0, x1, y1) pixel bounds, inclusive-exclusive


def triangle_setup(clip: Array, tri_idx: Array, tri_valid: Array,
                   width: int, height: int, cull_backfaces: bool,
                   depth_bias_constant: float = 0.0,
                   depth_bias_slope: float = 0.0) -> TriangleSetup:
    """Build per-triangle edge/interpolation rows from clip coordinates.

    ``cull_backfaces``: FrontFace::Ccw + cull Back for fill pipelines
    (reference src/lib.rs:193-194); wireframe draws both sides
    (src/lib.rs:252-253).  Depth bias implements the shadow pipeline's
    constant=2 / slope_scale=2 state (reference src/lib.rs:896-900).
    """
    T = tri_idx.shape[0]
    # one wide row gather of the three corners' clip rows, then planes
    c12 = jnp.take(clip, tri_idx.reshape(-1), axis=0) \
        .reshape(T, 12).T                       # (12, T): rows per corner
    x = (c12[0], c12[4], c12[8])
    y = (c12[1], c12[5], c12[9])
    z = (c12[2], c12[6], c12[10])
    w = (c12[3], c12[7], c12[11])
    return _setup_from_corner_planes(
        x, y, z, w, tri_valid, width, height, cull_backfaces,
        depth_bias_constant, depth_bias_slope)


def triangle_setup_corners(clip_c, tri_valid: Array,
                           width: int, height: int, cull_backfaces: bool,
                           depth_bias_constant: float = 0.0,
                           depth_bias_slope: float = 0.0) -> TriangleSetup:
    """``triangle_setup`` from corner-major clip planes (no gather).

    ``clip_c``: 3 corners × (x, y, z, w) planes, each (T,) — the output of
    ``run_vertex_stage_corners``.
    """
    x, y, z, w = (tuple(clip_c[k][i] for k in range(3)) for i in range(4))
    return _setup_from_corner_planes(
        x, y, z, w, tri_valid, width, height, cull_backfaces,
        depth_bias_constant, depth_bias_slope)


def _setup_from_corner_planes(x, y, z, w, tri_valid, width, height,
                              cull_backfaces, depth_bias_constant,
                              depth_bias_slope):
    T = x[0].shape[0]

    # Homogeneous screen coords: px/pw = pixel x.  NDC y-up → pixel y-down.
    px = tuple((0.5 * x[k] + 0.5 * w[k]) * width for k in range(3))
    py = tuple((0.5 * w[k] - 0.5 * y[k]) * height for k in range(3))
    pw = w

    def cross(a, b2):  # 3-plane cross product of corner vectors
        return (py[a] * pw[b2] - pw[a] * py[b2],
                pw[a] * px[b2] - px[a] * pw[b2],
                px[a] * py[b2] - py[a] * px[b2])

    r0 = cross(1, 2)
    r1 = cross(2, 0)
    r2 = cross(0, 1)
    det = px[0] * r0[0] + py[0] * r0[1] + pw[0] * r0[2]

    # wgpu FrontFace::Ccw: outward-CCW-wound triangles (right-handed model
    # space, the standard OBJ convention) are front faces when they face the
    # camera.  Such triangles are CCW in y-up NDC and flip to det < 0 in
    # this y-down screen determinant convention.  Inside pixels satisfy
    # l_i = det * λ_i, so scaling the rows by sign(det) normalizes to
    # inside => l_i >= 0 for either winding.
    sgn = jnp.where(det < 0, -1.0, 1.0)
    r0 = tuple(v * sgn for v in r0)
    r1 = tuple(v * sgn for v in r1)
    r2 = tuple(v * sgn for v in r2)

    valid = tri_valid & (det != 0.0)
    if cull_backfaces:
        valid = valid & (det < 0.0)

    # Frustum rejection — keeps invisible geometry out of the binner
    # (unprojectable bboxes would otherwise go conservative-full-screen).
    # wgpu clip volume: -w<=x<=w, -w<=y<=w, 0<=z<=w.
    #  * all three w <= 0: entirely behind the eye plane → cull;
    #  * all w > 0: standard same-plane outcode test;
    #  * mixed-sign w: keep (conservative — plane tests flip for w < 0).
    def all3(f):
        return f(0) & f(1) & f(2)

    behind = all3(lambda k: w[k] <= 1e-30)
    all_front = all3(lambda k: w[k] > 0.0)
    out_plane = (all3(lambda k: x[k] < -w[k]) | all3(lambda k: x[k] > w[k])
                 | all3(lambda k: y[k] < -w[k]) | all3(lambda k: y[k] > w[k])
                 | all3(lambda k: z[k] < 0.0) | all3(lambda k: z[k] > w[k]))
    valid = valid & ~behind & ~(all_front & out_plane)

    # Depth row: NDC z(p) is AFFINE in screen space.  The corner planes
    # are the adjugate rows of the homogeneous screen matrix C (columns
    # (px_i, py_i, pw_i)), so C·R = det·I makes the interpolated w
    # ww(p) = Σ l_i(p)·w_i ≡ det·sgn = |det| — CONSTANT per triangle —
    # and z(p) = zw(p)/ww(p) = (Σ l_i(p)·z_i)/|det|: one affine plane,
    # exact for external (near-plane-crossing) triangles too.  This is
    # the classical screen-affine depth, derived directly from the 2DH
    # setup; it removes the per-pixel rational divide and the cross-
    # multiplied depth tournament from the raster kernels, and the depth
    # clip z ∈ [0, w] becomes z(p) ∈ [0, 1].
    rdet = 1.0 / jnp.where(det != 0.0, det * sgn, 1.0)
    zrow = tuple((r0[j] * z[0] + r1[j] * z[1] + r2[j] * z[2]) * rdet
                 for j in range(3))

    if depth_bias_constant or depth_bias_slope:
        # z is affine: its pixel gradient IS (zrow[0], zrow[1]) exactly
        # (the old rational form needed a vertex-averaged ww estimate).
        max_slope = jnp.maximum(jnp.abs(zrow[0]), jnp.abs(zrow[1]))
        bias = depth_bias_slope * max_slope \
            + depth_bias_constant * (2.0 ** -23)
        zrow = (zrow[0], zrow[1], zrow[2] + bias)

    # Screen bbox of the VISIBLE portion.  External (near-plane-crossing)
    # triangles would project to unbounded regions, so the bbox — and only
    # the bbox; coverage stays homogeneous and clip-free — is computed from
    # the triangle clipped against w = eps: up to 3 front vertices plus up
    # to 3 edge/near-plane intersection points.  This keeps near geometry
    # tightly binned instead of conservative-full-screen.
    eps = 1e-6
    front = tuple(w[k] > eps for k in range(3))
    inf = jnp.float32(jnp.inf)

    min_x = jnp.full((T,), jnp.inf, jnp.float32)
    min_y = jnp.full((T,), jnp.inf, jnp.float32)
    max_x = jnp.full((T,), -jnp.inf, jnp.float32)
    max_y = jnp.full((T,), -jnp.inf, jnp.float32)
    for k in range(3):
        sx = px[k] / jnp.where(front[k], pw[k], 1.0)
        sy = py[k] / jnp.where(front[k], pw[k], 1.0)
        min_x = jnp.minimum(min_x, jnp.where(front[k], sx, inf))
        min_y = jnp.minimum(min_y, jnp.where(front[k], sy, inf))
        max_x = jnp.maximum(max_x, jnp.where(front[k], sx, -inf))
        max_y = jnp.maximum(max_y, jnp.where(front[k], sy, -inf))
    for a, b2 in ((0, 1), (1, 2), (2, 0)):
        crosses = front[a] != front[b2]
        denom = w[b2] - w[a]
        t = (eps - w[a]) / jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
        ix = jnp.clip((px[a] + t * (px[b2] - px[a])) / eps,
                      -1.0, width + 1.0)
        iy = jnp.clip((py[a] + t * (py[b2] - py[a])) / eps,
                      -1.0, height + 1.0)
        min_x = jnp.minimum(min_x, jnp.where(crosses, ix, inf))
        min_y = jnp.minimum(min_y, jnp.where(crosses, iy, inf))
        max_x = jnp.maximum(max_x, jnp.where(crosses, ix, -inf))
        max_y = jnp.maximum(max_y, jnp.where(crosses, iy, -inf))

    # width/height may be TRACED scalars (the resize-without-recompile
    # path renders into a static padded target while the live view size
    # rides the trace — runtime/loop.py); every use below is jnp math.
    wf = jnp.asarray(width, jnp.float32)
    hf = jnp.asarray(height, jnp.float32)
    x0 = jnp.clip(jnp.floor(min_x), 0, wf)
    y0 = jnp.clip(jnp.floor(min_y), 0, hf)
    x1 = jnp.clip(jnp.ceil(max_x) + 1.0, 0, wf)
    y1 = jnp.clip(jnp.ceil(max_y) + 1.0, 0, hf)
    onscreen = (x1 > x0) & (y1 > y0)
    valid = valid & onscreen

    # Invalid triangles get an empty bbox so binning skips them.
    x1 = jnp.where(valid, x1, 0.0)
    y1 = jnp.where(valid, y1, 0.0)
    x0 = jnp.where(valid, x0, wf)
    y0 = jnp.where(valid, y0, hf)

    # Invalid triangles get zeroed rows with e0.c = −1 (l0 ≡ −1 → never
    # covered anywhere), so the rasterizers need no separate validity
    # test.  The constant must be strictly negative — all-zero rows would
    # satisfy the coverage test (min of zeros ≥ 0) and their (zw=0, ww=0)
    # tournament entry would tie-and-hold against real triangles.  Lane 15
    # keeps the flag for diagnostics.
    vf = valid.astype(jnp.float32)
    zero = jnp.zeros_like(vf)
    planes = [r0[0] * vf, r0[1] * vf, r0[2] * vf - (1.0 - vf),
              r1[0] * vf, r1[1] * vf, r1[2] * vf,
              r2[0] * vf, r2[1] * vf, r2[2] * vf,
              zrow[0] * vf, zrow[1] * vf, zrow[2] * vf,
              zero, zero, zero,
              vf]
    setup = jnp.stack(planes, axis=1)
    bbox = jnp.stack([x0, y0, x1, y1], axis=1)
    return TriangleSetup(setup=setup, bbox=bbox)
