"""Analytic fragment tests: shade_lit vs HAND-COMPUTED reference values.

Unlike the golden images (which regression-test the code against itself),
these evaluate the reference WGSL fragment program by hand (numpy float64,
explicit constants from src/shader.wgsl:163-262) for a synthetic fragment
with a friendly geometry (identity TBN, axis-aligned view) and assert the
renderer's shading matches.  A shading-constant typo (attenuation
coefficients, ambient scale, the ×10/0.5 sun factors, the Reinhard curve,
the PCF kernel) fails these tests.
"""

import numpy as np
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.core.types import Scene
from kanirenderer_tpu.ops.interpolate import PixelBuffer, USED
from kanirenderer_tpu.ops.sampling import build_shadow_table, sample_shadow_pcf
from kanirenderer_tpu.shade import forward

H = W = 4


def _flat_material_scene(diffuse=(0.5, 0.5, 0.5),
                         normal=(0.5, 0.5, 1.0)) -> Scene:
    """1×1-texel material: diffuse constant (linear), normal-map constant."""
    from kanirenderer_tpu.ops.sampling import build_material_blocks
    dtbl = build_material_blocks(
        np.asarray(diffuse, np.float32)[None, None, :])
    ntbl = build_material_blocks(
        np.asarray(normal, np.float32)[None, None, :])
    z3 = jnp.zeros((1, 3), jnp.float32)
    return Scene(
        position=z3, uv=jnp.zeros((1, 2), jnp.float32), normal=z3,
        tangent=z3, bitangent=z3,
        vertex_object=jnp.zeros((1,), jnp.int32),
        tri_idx=jnp.zeros((1, 3), jnp.int32),
        tri_mat=jnp.zeros((1,), jnp.int32),
        tri_valid=jnp.zeros((1,), bool),
        object_model=jnp.eye(4)[None], object_normal=jnp.eye(3)[None],
        tex_diffuse=jnp.asarray(dtbl, jnp.bfloat16),
        tex_normal=jnp.asarray(ntbl, jnp.bfloat16),
        mat_blk_base=jnp.zeros((1,), jnp.int32),
        mat_blk_w=jnp.ones((1,), jnp.int32),
        mat_tex_size=jnp.ones((1, 2), jnp.int32))


CAMERA_POS = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)  # view from +Z

# With identity TBN and the fragment at the origin, the derived
# tangent-space view/light positions equal the world positions, so a
# movable light at (0, 0, 2) gives light_dir (0, 0, 1) and dist 2.
LIGHTS = kani.default_lights()
LIGHTS = LIGHTS._replace(movable=LIGHTS.movable._replace(
    position=jnp.asarray([0.0, 0.0, 2.0], jnp.float32)))


def _shadow_lvp(shadow_uv=(0.5, 0.5, 0.5)) -> jnp.ndarray:
    """A light view-projection whose derived shadow coord at the origin
    (forward.shadow_coords: uv = clip.xy·(0.5, −0.5) + 0.5, raw z) is
    exactly ``shadow_uv``."""
    lvp = np.zeros((4, 4), np.float32)
    lvp[0, 3] = (shadow_uv[0] - 0.5) / 0.5
    lvp[1, 3] = (shadow_uv[1] - 0.5) / -0.5
    lvp[2, 3] = shadow_uv[2]
    return jnp.asarray(lvp)


def _fragment() -> PixelBuffer:
    """A fragment at the origin with identity TBN."""
    v = np.zeros((USED, H, W), np.float32)
    v[3:6] = np.array([1.0, 0.0, 0.0])[:, None, None]   # TBN rows: identity
    v[6:9] = np.array([0.0, 1.0, 0.0])[:, None, None]
    v[9:12] = np.array([0.0, 0.0, 1.0])[:, None, None]
    v[15:17] = 0.5                                       # UV → texel (0,0)
    plane_i = jnp.zeros((H, W), jnp.int32)
    return PixelBuffer(
        varyings=jnp.asarray(v), mat_id=plane_i,
        tex_w=jnp.ones((H, W), jnp.int32), tex_h=jnp.ones((H, W), jnp.int32),
        blk_base=plane_i, blk_w=jnp.ones((H, W), jnp.int32),
        mask=jnp.ones((H, W), bool),
        z=jnp.full((H, W), 0.5, jnp.float32))


def _expected_lit(shadow_factor: float) -> np.ndarray:
    """Reference fragment math by hand (src/shader.wgsl:163-262), f64."""
    obj = 0.5                       # 0.5 is exact in bf16
    n = np.array([0.0, 0.0, 1.0])
    view_dir = np.array([0.0, 0.0, 1.0])

    # movable point light (lib.rs:433-446 color/range; position moved to
    # (0, 0, 2) so direction and distance are both axis-friendly)
    dist = 2.0
    att = 1.0 / (1.0 + 0.09 * dist + 0.032 * dist * dist) \
        * np.clip(1.0 - (dist / 256.0) ** 4, 0.0, 1.0)
    light_dir = np.array([0.0, 0.0, 1.0])
    half = (view_dir + light_dir) / np.linalg.norm(view_dir + light_dir)
    diff = max(n @ light_dir, 0.0) * 20.0
    spec = max(n @ half, 0.0) ** 32 * 20.0
    movable = (diff + spec) * att * obj

    ambient = 20.0 * 0.0005 * obj

    # directional light (light.rs:69-78): dir (0,-0.9902682,-0.1391731)
    d = np.array([0.0, -0.9902682, -0.1391731])
    dl = -d / np.linalg.norm(d)
    half_d = (view_dir + dl) / np.linalg.norm(view_dir + dl)
    dl_diff = max(n @ dl, 0.0) * 10.0
    dl_spec = max(n @ half_d, 0.0) ** 32 * (10.0 * 0.5)
    dl_term = (dl_diff + dl_spec) * shadow_factor * obj

    c = ambient + movable + dl_term         # dummy point light is black
    return np.full(3, c / (c + 1.0))        # Reinhard


def test_shade_lit_hand_computed():
    scene = _flat_material_scene()
    got = np.asarray(forward.shade_lit(scene, _fragment(), LIGHTS, None,
                                       hdr=False, camera_pos=CAMERA_POS))
    expected = _expected_lit(shadow_factor=1.0)
    np.testing.assert_allclose(got[:, 2, 2], expected, atol=2e-6)


def test_shade_lit_shadow_hand_computed():
    # Shadow map: left half occluded (0.0), right half lit (1.0); the
    # fragment samples the exact column boundary at depth 0.5 → by the
    # 3×3 PCF hand-expansion the factor is (3 · 1.5)/9 = 0.5.
    D = 16
    sm = np.zeros((D, D), np.float32)
    sm[:, D // 2:] = 1.0
    tbl = build_shadow_table(jnp.asarray(sm))
    scene = _flat_material_scene()
    got = np.asarray(forward.shade_lit(
        scene, _fragment(), LIGHTS, tbl, hdr=False, shadow_dim=D,
        camera_pos=CAMERA_POS, light_vp=_shadow_lvp((0.5, 0.5, 0.5))))
    expected = _expected_lit(shadow_factor=0.5)
    np.testing.assert_allclose(got[:, 2, 2], expected, atol=2e-6)


def test_pcf_factor_hand_computed():
    """PCF at a hard shadow edge for several sub-texel offsets."""
    D = 16
    sm = np.zeros((D, D), np.float32)
    sm[:, D // 2:] = 1.0
    tbl = build_shadow_table(jnp.asarray(sm))
    depth = jnp.full((1, 1), 0.5, jnp.float32)
    vv = jnp.full((1, 1), 0.5, jnp.float32)
    for fx, want in [(0.0, (3 * 1.0) / 9),    # taps at x=6..9 → cols 8,9 lit
                     (0.5, (3 * 1.5) / 9),
                     (0.25, (3 * 1.25) / 9),
                     (1.0 - 1e-6, (3 * 2.0) / 9)]:
        u = jnp.full((1, 1), (7 + fx + 0.5) / D, jnp.float32)
        got = float(sample_shadow_pcf(tbl, D, u, vv, depth)[0, 0])
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_ambient_only_when_unlit_directions():
    """Back-facing fragment (normal −Z): every max(dot,0) clamps to 0 —
    only ambient survives (src/shader.wgsl:179-181)."""
    scene = _flat_material_scene(normal=(0.5, 0.5, 0.0))  # raw n = (0,0,-1)
    got = np.asarray(forward.shade_lit(scene, _fragment(), LIGHTS, None,
                                       hdr=False, camera_pos=CAMERA_POS))
    c = 20.0 * 0.0005 * 0.5
    np.testing.assert_allclose(got[:, 1, 1], np.full(3, c / (c + 1)),
                               atol=2e-6)


def test_pcf_penumbra_ramp_hand_computed():
    """PCF over a depth RAMP (hand-derived penumbra, reference
    src/shader.wgsl:140-159 + the LessEqual comparison sampler,
    src/lib.rs:761-767).  Hardware PCF compares BEFORE filtering: each
    tap bilinearly blends per-texel 0/1 comparison results, so with
    map(x) = (x + 0.5)/D and receiver depth c the per-texel lit bit is
    (c <= map(x)) — a step at texel x* = c*D - 0.5 — and the 9-tap sum
    is a piecewise-linear penumbra of width 4 texels.  A filter-before-
    compare implementation (the classic mistake) would produce a HARD
    step here; these values fail then."""
    D = 16
    xs = (np.arange(D, dtype=np.float64) + 0.5) / D
    sm = np.tile(xs[None, :], (D, 1)).astype(np.float32)   # depth ramp in u
    tbl = build_shadow_table(jnp.asarray(sm))
    vv = jnp.full((1, 1), 0.5, jnp.float32)

    def expected(u_texel, c):
        # 3×3 taps of bilinear comparisons collapse (separably) to a
        # 4-texel window [i−1, i, i+1, i+2] with weights [1−f, 1, 1, f]
        # per axis (i = floor(u_texel), f = frac); the v axis is uniform
        # here so the row sum appears 3× and the total divides by 9.
        i = int(np.floor(u_texel))
        f = u_texel - i

        def lit(t):
            t = min(max(t, 0), D - 1)
            return 1.0 if c <= (t + 0.5) / D else 0.0

        row = ((1 - f) * lit(i - 1) + lit(i) + lit(i + 1) + f * lit(i + 2))
        return 3.0 * row / 9.0

    c = 0.5  # step at texel 7.5: texels ≥ 8 lit
    for u_texel in [5.0, 6.25, 7.0, 7.75, 8.5, 9.0, 10.5]:
        u = jnp.full((1, 1), (u_texel + 0.5) / D, jnp.float32)
        got = float(sample_shadow_pcf(
            tbl, D, u, vv, jnp.full((1, 1), c, jnp.float32))[0, 0])
        np.testing.assert_allclose(got, expected(u_texel, c), atol=1e-5,
                                   err_msg=f"u_texel={u_texel}")


def test_aces_tonemap_hand_computed():
    """ACES filmic curve constants (reference src/shader_hdr.wgsl:254-265)
    against hand-evaluated f64 values."""
    from kanirenderer_tpu.core.color import aces_tonemap
    for c in [0.0, 0.18, 0.5, 1.0, 2.0, 10.0]:
        want = np.clip((c * (2.51 * c + 0.03)) / (c * (2.43 * c + 0.59)
                                                  + 0.14), 0.0, 1.0)
        got = float(aces_tonemap(jnp.float32(c)))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-7)


def test_deferred_lighting_hand_computed():
    """Deferred pixel: world-space sun + G-buffer
    8-bit albedo quantization + bf16 attachment storage, hand-evaluated
    in f64 against the scaffolding's intended math
    (src/deferredRenderPipeline.rs:193-271 — the lighting rig of
    src/shader.wgsl:171-257 in world space, ACES for the HDR surface).

    The albedo 0.3 is chosen to be INEXACT in both storage formats: it
    lands at bf16(0.3)=0.30078125 in the material table, then quantizes
    to round(.30078125*255)/255 = 77/255 in the 8-bit G-buffer — a
    missing quantization step fails this test."""
    from kanirenderer_tpu.shade import deferred as dmod

    D = 16
    sm = np.zeros((D, D), np.float32)
    sm[:, D // 2:] = 1.0          # PCF factor 0.5 at the column boundary
    tbl = build_shadow_table(jnp.asarray(sm))
    scene = _flat_material_scene(diffuse=(0.3, 0.3, 0.3))
    lvp = _shadow_lvp((0.5, 0.5, 0.5))
    gbuf = dmod.write_gbuffer(scene, _fragment(), CAMERA_POS, lvp)

    # G-buffer contents themselves, hand-checked
    alb = float(np.float32(np.asarray(jnp.bfloat16(0.3), np.float32)))
    alb_q = round(alb * 255.0) / 255.0
    np.testing.assert_allclose(np.asarray(gbuf.albedo)[:, 2, 2],
                               np.full(3, alb_q), atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(gbuf.normal.astype(jnp.float32))[:, 2, 2],
        [0.0, 0.0, 1.0], atol=0)   # (0,0,1) is exact in bf16

    got = np.asarray(dmod.deferred_lighting(gbuf, LIGHTS, tbl, hdr=True,
                                            shadow_dim=D))

    # --- hand evaluation, float64 ---
    n = np.array([0.0, 0.0, 1.0])
    view = np.array([0.0, 0.0, 1.0])
    # movable point light at (0,0,2), color 20 (lib.rs:433-446)
    dist = 2.0
    att = 1.0 / (1.0 + 0.09 * dist + 0.032 * dist * dist) \
        * np.clip(1.0 - (dist / 256.0) ** 4, 0.0, 1.0)
    ldir = np.array([0.0, 0.0, 1.0])
    half = (view + ldir) / np.linalg.norm(view + ldir)
    movable = (max(n @ ldir, 0.0) * 20.0
               + max(n @ half, 0.0) ** 32 * 20.0) * att
    ambient = 20.0 * 0.0005
    # directional sun, world-space correct (the deferred path's
    # documented intentional divergence from the forward shader's
    # tangent-space quirk): dl = -d/|d|
    d = np.array([0.0, -0.9902682, -0.1391731])
    dl = -d / np.linalg.norm(d)
    half_d = (view + dl) / np.linalg.norm(view + dl)
    sun = (max(n @ dl, 0.0) * 10.0
           + max(n @ half_d, 0.0) ** 32 * (10.0 * 0.5)) * 0.5  # PCF 0.5
    c = (movable + ambient + sun) * alb_q
    want = np.clip((c * (2.51 * c + 0.03)) / (c * (2.43 * c + 0.59)
                                              + 0.14), 0.0, 1.0)
    np.testing.assert_allclose(got[:, 2, 2], np.full(3, want), atol=4e-6)


def test_wireframe_edge_distance_coverage_hand_computed():
    """Wireframe coverage: a pixel is covered iff its
    center lies inside the triangle AND within wire_thresh=0.7 px of an
    edge (the PolygonMode::Line analog, reference src/lib.rs:254 +
    src/shader_wireframe.wgsl:140-144 flat white).  Hand-derived f64
    point-line distances for a right triangle with the hypotenuse
    x+y=31: the pixel center (14.5, 15.5) sits at d = 1/sqrt(2) =
    0.70711 px — just OUTSIDE the 0.7 threshold — while (15.5, 15.5)
    sits on the edge (d=0) and (11.5, 13.5) is interior at d=1.0:
    a signed-distance normalization bug (missing |grad| divide, wrong
    half-width) flips these."""
    from kanirenderer_tpu.ops.raster_xla import rasterize_xla
    from kanirenderer_tpu.ops.vertex import triangle_setup

    Wd = Ht = 32

    def ndc(sx, sy):
        return [(sx / Wd) * 2.0 - 1.0, 1.0 - (sy / Ht) * 2.0, 0.5, 1.0]

    # screen-space vertices (A at the right angle)
    tri = np.array([ndc(10.5, 10.5), ndc(20.5, 10.5), ndc(10.5, 20.5)],
                   np.float32)
    st = triangle_setup(jnp.asarray(tri), jnp.asarray([[0, 1, 2]]),
                        jnp.asarray([True]), Wd, Ht, cull_backfaces=False)
    vis = rasterize_xla(st.setup, Wd, Ht, wireframe=True, wire_thresh=0.7)
    mask = np.asarray(vis.tri) >= 0

    def hand_d(px, py):
        """f64 min distance from pixel center to the three edge lines."""
        A, B, C = (10.5, 10.5), (20.5, 10.5), (10.5, 20.5)
        p = np.array([px, py], np.float64)

        def line_d(P, Q):
            P, Q = np.asarray(P, np.float64), np.asarray(Q, np.float64)
            t = Q - P
            return abs(np.cross(t, p - P)) / np.linalg.norm(t)

        return min(line_d(A, B), line_d(B, C), line_d(C, A))

    # (pixel x, pixel y) -> expected coverage; centers at (+0.5, +0.5)
    cases = {
        (14, 15): False,  # hypotenuse d = 1/sqrt(2) = 0.7071 > 0.7
        (15, 15): True,   # on the hypotenuse, d = 0
        (11, 13): False,  # interior, d = 1.0 to the vertical edge
        (10, 13): True,   # on the vertical edge x=10.5, d = 0
        (12, 10): True,   # on the horizontal edge y=10.5, d = 0
    }
    # pin the hand distances themselves before asserting coverage
    np.testing.assert_allclose(hand_d(14.5, 15.5), 1.0 / np.sqrt(2.0),
                               atol=1e-12)
    np.testing.assert_allclose(hand_d(11.5, 13.5), 1.0, atol=1e-12)
    # hypotenuse d at (14.5, 14.5) is 2/sqrt(2) = 1.414 -> interior, off
    cases[(14, 14)] = bool(hand_d(14.5, 14.5) <= 0.7)
    for (px, py), want in cases.items():
        d = hand_d(px + 0.5, py + 0.5)
        inside = (px + 0.5 >= 10.5 and py + 0.5 >= 10.5
                  and (px + 0.5) + (py + 0.5) <= 31.0)
        assert bool(mask[py, px]) == (inside and d <= 0.7) == want, \
            f"pixel ({px},{py}): d={d:.4f} inside={inside} " \
            f"got={bool(mask[py, px])} want={want}"

    # threshold sweep brackets the hand value: the 0.7071-px pixel turns
    # on between wire_thresh 0.70 and 0.71
    vis71 = rasterize_xla(st.setup, Wd, Ht, wireframe=True,
                          wire_thresh=0.71)
    assert bool(np.asarray(vis71.tri)[15, 14] >= 0)
