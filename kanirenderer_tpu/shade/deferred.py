"""Deferred shading pipeline: G-buffer write + deferred lighting.

The reference only scaffolded this (src/deferredRenderPipeline.rs — gated
off by a hardcoded flag with ``todo!()`` at src/lib.rs:730-736, all five
WGSL files empty).  The Rust scaffolding fixes the intended design, which
this module implements for real:

* G-buffer attachments (src/deferredRenderPipeline.rs:4-69):
  normals + world position in float16-class storage, albedo in 8-bit;
  here: a channel-planar pytree of dense planes materialized from the
  visibility buffer in one pass;
* deferred lighting pass (src/deferredRenderPipeline.rs:193-271):
  a fullscreen pass over the G-buffer with the same light rig as the
  forward path — movable point light, directional light (with PCF
  shadows), the point-light storage array — evaluated in WORLD space
  (deferred pipelines cannot carry tangent-space varyings).

Intentional divergence from the forward path: the reference's forward
shaders dot the tangent-space normal against the *untransformed* world
directional-light vector (src/shader.wgsl:200-201 — the sun's lighting
there depends on each face's UV orientation).  A world-space deferred
pass cannot reproduce that mismatch; it computes the geometrically
correct sun term.  Point lights and ambient agree with the forward path
wherever tangent frames are orthonormal;
* HDR output via the ACES curve (or Reinhard for LDR surfaces), matching
  the forward tonemaps.

On a visibility-buffer renderer the G-buffer write is nearly free: the
raster already produced {tri, z, λ}, so "writing the G-buffer" is the
interpolation pass plus the material fetch — exactly the decoupling a GPU
deferred pipeline buys.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from kanirenderer_tpu.core.color import aces_tonemap, reinhard_tonemap
from kanirenderer_tpu.core.types import Lights, Scene
from kanirenderer_tpu.ops.interpolate import PixelBuffer
from kanirenderer_tpu.ops.sampling import sample_shadow_pcf
from kanirenderer_tpu.shade import forward

Array = jnp.ndarray


class GBuffer(NamedTuple):
    """Dense per-pixel geometry+material attributes (all channel-planar).

    Storage dtypes follow the reference scaffolding's attachment formats
    (src/deferredRenderPipeline.rs:4-69): normals/positions f16-class,
    albedo quantized 8-bit.
    """

    normal: Array      # (3, H, W) bf16 — world-space shading normal
    position: Array    # (3, H, W) f32 — world-space position
    albedo: Array      # (3, H, W) — 8-bit-quantized linear albedo
    depth: Array       # (H, W) f32
    shadow_uv: Array   # (3, H, W) f32 — light-space coord (u, v, depth)
    view_dir: Array    # (3, H, W) bf16 — world-space unit view vector
    mask: Array        # (H, W) bool


def write_gbuffer(scene: Scene, pix: PixelBuffer,
                  camera_pos: Array, light_vp: Array) -> GBuffer:
    """Materialize the G-buffer from interpolated varyings + materials
    (the fragmentWriteGBuffers stage the reference left empty)."""
    vary = pix.varyings
    albedo, obj_normal = forward.sample_materials(scene, pix)

    # world normal from the tangent-space normal map: n = nᵗT + nᵇB + nⁿN
    tn = obj_normal * 2.0 - 1.0
    t_row = vary[forward.TBN_T]
    b_row = vary[forward.TBN_B]
    n_row = vary[forward.TBN_N]
    n_world = (t_row * tn[0][None] + b_row * tn[1][None]
               + n_row * tn[2][None])
    n_world = forward._norm3(n_world)

    world_pos = vary[forward.WORLD_POS]
    view = forward._norm3(camera_pos[:, None, None] - world_pos)

    albedo_q = jnp.round(jnp.clip(albedo, 0.0, 1.0) * 255.0) / 255.0
    return GBuffer(
        normal=n_world.astype(jnp.bfloat16),
        position=world_pos,
        albedo=albedo_q,
        depth=pix.z,
        shadow_uv=jnp.stack(forward.shadow_coords(vary, light_vp)),
        view_dir=view.astype(jnp.bfloat16),
        mask=pix.mask,
    )


def deferred_lighting(gbuf: GBuffer, lights: Lights,
                      shadow_table: Array | None, hdr: bool,
                      shadow_dim: int = 0) -> Array:
    """Fullscreen lighting over the G-buffer (fragmentDeferredRendering).

    Same light rig and constants as the forward shaders
    (src/shader.wgsl:171-257), evaluated with world-space vectors.
    """
    n = gbuf.normal.astype(jnp.float32)
    view_dir = gbuf.view_dir.astype(jnp.float32)
    albedo = gbuf.albedo
    world_pos = gbuf.position
    shape = gbuf.mask.shape

    def point_light_term(lpos, lcol, lrange):
        dvec = lpos[:, None, None] - world_pos
        dist = jnp.sqrt(jnp.maximum(forward._dot3(dvec, dvec), 1e-30))
        ldir = dvec / dist[None]
        diff, spec = forward._blinn_phong(n, ldir, view_dir,
                                          lcol[:, None, None])
        return (diff + spec) * forward._attenuation(dist, lrange)[None]

    m = lights.movable
    acc = point_light_term(m.position, m.color, m.range)

    # ambient
    acc = acc + (20.0 * 0.0005)

    d = lights.directional
    dl_dir3 = -d.direction / jnp.linalg.norm(d.direction)
    dl_dir = jnp.broadcast_to(dl_dir3[:, None, None], (3,) + shape)
    dl_diff, dl_spec = forward._blinn_phong(n, dl_dir, view_dir,
                                            d.color[:, None, None])
    dl_term = dl_diff * 10.0 + dl_spec * (10.0 * 0.5)
    if shadow_table is not None:
        sh = sample_shadow_pcf(shadow_table, shadow_dim,
                               gbuf.shadow_uv[0], gbuf.shadow_uv[1],
                               gbuf.shadow_uv[2])
        dl_term = dl_term * sh[None]
    acc = acc + dl_term

    p = lights.points
    if p.position.shape[0] <= 4:
        for k in range(p.position.shape[0]):
            acc = acc + point_light_term(p.position[k], p.color[k],
                                         p.range[k])
    else:
        # spawned-light rigs: scan keeps compile time O(1) in light count
        acc, _ = jax.lax.scan(
            lambda a, l: (a + point_light_term(*l), None),
            acc, (p.position, p.color, p.range))

    result = acc * albedo
    return aces_tonemap(result) if hdr else reinhard_tonemap(result)


def gbuffer_debug_view(gbuf: GBuffer, which: str) -> Array:
    """Debug visualization of a G-buffer channel → (3, H, W) color."""
    if which == "normal":
        return gbuf.normal.astype(jnp.float32) * 0.5 + 0.5
    if which == "albedo":
        return gbuf.albedo
    if which == "position":
        p = gbuf.position
        scale = jnp.maximum(jnp.abs(p).max(), 1e-6)
        return jnp.abs(p) / scale
    if which == "depth":
        return jnp.broadcast_to(gbuf.depth[None], (3,) + gbuf.depth.shape)
    raise ValueError(which)
