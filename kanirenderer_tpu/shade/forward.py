"""Forward shading: dense per-pixel fragment math for the five render modes.

Faithful reimplementation of the reference fragment shaders as
channel-planar tensor ops — colors and vectors are (3, H, W), scalars are
(H, W) planes, so every operation is a dense elementwise plane op:

* lit+shadow LDR — reference src/shader.wgsl:163-262 (Reinhard tonemap)
* lit+shadow HDR — reference src/shader_hdr.wgsl (identical lighting,
  ACES tonemap)
* lit (no shadow) — reference src/lit_shader.wgsl:134-221
* unlit — reference src/unlit_shader.wgsl:97-103 (diffuse + Reinhard)
* wireframe — constant white (reference src/shader_wireframe.wgsl:140-144)

Lighting model (Blinn-Phong in tangent space, constants from
src/shader.wgsl:171-207): point-light attenuation
``1/(1 + 0.09 d + 0.032 d²)`` times range falloff
``clamp(1-(d/range)^4, 0, 1)``; ambient ``vec3(20)*0.0005``; directional
light at hardcoded 10.0 intensity with 0.5 specular strength, modulated by
3×3 PCF shadowing; a storage array of extra point lights whose specular
uses the *unnormalized* tangent normal (a reference quirk we keep,
src/shader.wgsl:242).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kanirenderer_tpu.core.color import aces_tonemap, reinhard_tonemap
from kanirenderer_tpu.core.types import Lights, Scene
from kanirenderer_tpu.ops.interpolate import PixelBuffer
from kanirenderer_tpu.ops.sampling import (sample_materials_blocks,
                                           sample_shadow_pcf)

Array = jnp.ndarray

# Varying plane slices (see ops/vertex.py layout)
TAN_POS = slice(0, 3)
TBN_T = slice(3, 6)
TBN_B = slice(6, 9)
TBN_N = slice(9, 12)
WORLD_POS = slice(12, 15)
UV = slice(15, 17)


def _dot3(a: Array, b: Array) -> Array:
    """(3, H, W)·(3, H, W) → (H, W)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def tbn_apply(vary: Array, p: Array) -> Array:
    """Tangent-space image of a constant world point: TBN rows · p.

    The reference computes these per VERTEX (tangent_view_position /
    tangent_light_position, src/shader.wgsl:106-112) and interpolates;
    TBN·p is linear in the interpolated TBN rows, so deriving it from
    the interpolated rows here is exact — and keeps 6 lanes out of the
    per-pixel record path."""
    t, b, n = vary[TBN_T], vary[TBN_B], vary[TBN_N]
    return jnp.stack([
        t[0] * p[0] + t[1] * p[1] + t[2] * p[2],
        b[0] * p[0] + b[1] * p[1] + b[2] * p[2],
        n[0] * p[0] + n[1] * p[1] + n[2] * p[2],
    ])


def shadow_coords(vary: Array, light_vp: Array) -> tuple[Array, Array, Array]:
    """Light-space (u, v, depth) from the interpolated world position.

    The reference emits shadow_coord per vertex (src/shader.wgsl:113-114:
    uv = clip.xy·(0.5, −0.5) + 0.5, raw z); the light projection is
    affine in world position (directional/ortho — no divide), so the
    per-pixel derivation is exact."""
    w = vary[WORLD_POS]
    L = light_vp
    su = (L[0, 0] * w[0] + L[0, 1] * w[1] + L[0, 2] * w[2]
          + L[0, 3]) * 0.5 + 0.5
    sv = (L[1, 0] * w[0] + L[1, 1] * w[1] + L[1, 2] * w[2]
          + L[1, 3]) * -0.5 + 0.5
    sz = L[2, 0] * w[0] + L[2, 1] * w[1] + L[2, 2] * w[2] + L[2, 3]
    return su, sv, sz


def _norm3(v: Array) -> Array:
    n2 = _dot3(v, v)
    return v * jax.lax.rsqrt(jnp.maximum(n2, 1e-30))[None]


def _splat(c, shape) -> Array:
    """Constant vec3 → (3, H, W)."""
    return jnp.broadcast_to(jnp.asarray(c, jnp.float32)[:, None, None],
                            (3,) + shape)


def sample_materials(scene: Scene, pix: PixelBuffer) -> tuple[Array, Array]:
    """Per-pixel diffuse (linear RGB) and raw normal-map samples, planar.

    All-u8 scenes pack both textures into ONE combined block table —
    a single row gather serves diffuse AND normal; higher-depth normal
    maps fall back to one gather per texture (see ops/sampling.py)."""
    if scene.tex_combined.shape[0] > 0:
        from kanirenderer_tpu.ops.sampling import sample_materials_combined
        return sample_materials_combined(scene.tex_combined,
                                         pix.blk_base, pix.blk_w,
                                         pix.tex_w, pix.tex_h,
                                         pix.varyings[15], pix.varyings[16])
    return sample_materials_blocks(scene.tex_diffuse, scene.tex_normal,
                                   pix.blk_base, pix.blk_w, pix.tex_w,
                                   pix.tex_h,
                                   pix.varyings[15], pix.varyings[16])


def shade_unlit(scene: Scene, pix: PixelBuffer) -> Array:
    """Diffuse sample + Reinhard (reference src/unlit_shader.wgsl:97-103)."""
    object_color, _ = sample_materials(scene, pix)
    return reinhard_tonemap(object_color)


def shade_wireframe(pix: PixelBuffer) -> Array:
    """Constant white (reference src/shader_wireframe.wgsl:140-144)."""
    return jnp.ones((3,) + pix.mask.shape, jnp.float32)


def _blinn_phong(tangent_normal: Array, light_dir: Array, view_dir: Array,
                 light_color: Array) -> tuple[Array, Array]:
    half_dir = _norm3(view_dir + light_dir)
    diff = jnp.maximum(_dot3(tangent_normal, light_dir), 0.0)
    s1 = jnp.maximum(_dot3(tangent_normal, half_dir), 0.0)
    # x^32 by five squarings — jnp ** 32.0 lowers to a transcendental
    # pow (exp·log), far costlier at 2M px × 3 ch × lights.
    s2 = s1 * s1
    s4 = s2 * s2
    s8 = s4 * s4
    s16 = s8 * s8
    spec = s16 * s16
    return light_color * diff[None], light_color * spec[None]


def _attenuation(dist: Array, rng: Array) -> Array:
    att = 1.0 / (1.0 + 0.09 * dist + 0.032 * dist * dist)
    q = dist / jnp.maximum(rng, 1e-20)
    q2 = q * q
    range_att = jnp.clip(1.0 - q2 * q2, 0.0, 1.0)
    return att * range_att


def shade_lit(scene: Scene, pix: PixelBuffer, lights: Lights,
              shadow_table: Array | None, hdr: bool,
              shadow_dim: int = 0, *, camera_pos: Array,
              light_vp: Array | None = None) -> Array:
    """Blinn-Phong forward shading, optionally shadow-modulated.

    shadow_table None → the Lit pipeline (reference src/lit_shader.wgsl);
    otherwise LitWithShadow (src/shader.wgsl with Reinhard, or
    src/shader_hdr.wgsl with ACES when hdr=True); shadow_table is the
    block-window table from ops/sampling.build_shadow_table, and
    ``light_vp`` the directional light's view-projection (required with
    a shadow_table — shadow coords derive from world position here; see
    ``shadow_coords``).
    """
    object_color, object_normal = sample_materials(scene, pix)
    vary = pix.varyings
    shape = pix.mask.shape

    tangent_normal_raw = object_normal * 2.0 - 1.0
    tangent_normal = _norm3(tangent_normal_raw)

    tan_pos = vary[TAN_POS]
    view_dir = _norm3(tbn_apply(vary, camera_pos) - tan_pos)

    # --- movable point light (uniform `light`) ---
    world_pos = vary[WORLD_POS]
    m = lights.movable
    dvec = m.position[:, None, None] - world_pos
    dist = jnp.sqrt(jnp.maximum(_dot3(dvec, dvec), 1e-30))
    light_dir = _norm3(tbn_apply(vary, m.position) - tan_pos)
    mcol = m.color[:, None, None]
    diff, spec = _blinn_phong(tangent_normal, light_dir, view_dir, mcol)
    movable_term = (diff + spec) * _attenuation(dist, m.range)[None] \
        * object_color

    # --- ambient (reference src/shader.wgsl:179-181) ---
    ambient_term = (20.0 * 0.0005) * object_color

    # --- directional light ---
    d = lights.directional
    dl_dir3 = -d.direction / jnp.linalg.norm(d.direction)
    dl_dir = jnp.broadcast_to(dl_dir3[:, None, None], (3,) + shape)
    dcol = d.color[:, None, None]
    dl_diff, dl_spec = _blinn_phong(tangent_normal, dl_dir, view_dir, dcol)
    dl_term = dl_diff * 10.0 + dl_spec * (10.0 * 0.5)
    if shadow_table is not None:
        su, sv, sz = shadow_coords(vary, light_vp)
        shadow = sample_shadow_pcf(shadow_table, shadow_dim, su, sv, sz)
        dl_term = dl_term * shadow[None]
    dl_term = dl_term * object_color

    # --- point-light storage array (reference src/shader.wgsl:225-257) ---
    t_row = vary[TBN_T]
    b_row = vary[TBN_B]
    n_row = vary[TBN_N]
    p = lights.points
    P = p.position.shape[0]

    def one_light(acc, light):
        lp, pcol3, prange = light
        pdvec = lp[:, None, None] - world_pos
        pdist = jnp.sqrt(jnp.maximum(_dot3(pdvec, pdvec), 1e-30))
        # tangent-space light position: TBN rows · light_pos
        tl = jnp.stack([
            t_row[0] * lp[0] + t_row[1] * lp[1] + t_row[2] * lp[2],
            b_row[0] * lp[0] + b_row[1] * lp[1] + b_row[2] * lp[2],
            n_row[0] * lp[0] + n_row[1] * lp[1] + n_row[2] * lp[2],
        ])
        pl_dir = _norm3(tl - tan_pos)
        pcol = pcol3[:, None, None]
        # NOTE: loop lights use the unnormalized tangent normal
        # (reference src/shader.wgsl:242).
        pdiff, pspec = _blinn_phong(tangent_normal_raw, pl_dir, view_dir,
                                    pcol)
        patt = _attenuation(pdist, prange)
        return acc + (pdiff + pspec) * patt[None]

    init = jnp.zeros((3,) + shape, jnp.float32)
    if P <= 4:
        # small arrays unroll (XLA fuses the whole sum)
        points_term = init
        for k in range(P):
            points_term = one_light(points_term,
                                    (p.position[k], p.color[k], p.range[k]))
    else:
        # spawned-light rigs (tens to hundreds of lights, reference
        # src/lib.rs:453-512): lax.scan keeps the traced graph and the
        # compile time O(1) in the light count; the sequential
        # accumulation order matches the unrolled loop exactly.
        points_term, _ = jax.lax.scan(
            lambda acc, light: (one_light(acc, light), None),
            init, (p.position, p.color, p.range))
    points_term = points_term * object_color

    result = ambient_term + dl_term + movable_term + points_term
    return aces_tonemap(result) if hdr else reinhard_tonemap(result)
