"""Core datatypes: scene, camera, lights, render settings.

Dynamic state (anything that changes per frame) lives in NamedTuple pytrees of
jnp arrays so the whole render step stays jittable.  Static configuration
(resolutions, render mode, capacities) lives in the hashable frozen dataclass
``RenderConfig`` which is passed as a static argument — one compiled executable
per mode, mirroring the reference's six prebuilt pipelines
(reference src/lib.rs:868-1096).

Scene layout (flat arrays, not the reference's per-mesh buffer objects): all
meshes of all models are packed into flat arrays.  Triangles are Morton-sorted
at load time into fixed-size chunks so per-frame binning can operate on
chunk-granularity screen bounding boxes (see ops/binning.py).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import numpy as _np

import jax.numpy as jnp

Array = jnp.ndarray

# Triangles per binning chunk.  Triangles are Morton-ordered at scene
# build (io/scene_loader.py) so consecutive chunks are spatially compact.
CHUNK_SIZE = 128

# Triangles per raster subbatch: the binner records, per (tile, chunk)
# pair, one overlap bit per subbatch (tile rect vs subbatch bbox), and the
# tile kernel skips subbatches whose bit is clear.  The mask of a chunk
# fits an int32.
SUBBATCH = 16
SUBS_PER_CHUNK = CHUNK_SIZE // SUBBATCH
assert CHUNK_SIZE % SUBBATCH == 0 and SUBS_PER_CHUNK <= 31


class RenderMode(enum.IntEnum):
    """Tab-cycled render modes (reference src/lib.rs:65-71, 1221-1229)."""

    UNLIT = 0
    LIT = 1
    LIT_SHADOW = 2
    WIREFRAME = 3
    DEBUG = 4  # LitWithShadow shading + depth/shadow + frame-time overlays

    def next(self) -> "RenderMode":
        return RenderMode((int(self) + 1) % 5)


class DebugTexture(enum.IntEnum):
    """Key1-toggled debug overlay source (reference src/lib.rs:1282-1327)."""

    SCENE_DEPTH = 0
    SHADOW_MAP = 1


class Scene(NamedTuple):
    """Packed device-resident scene.  All shapes static per scene build.

    Geometry is expanded over (model, instance) pairs = "objects": every
    vertex row carries the object id whose (dynamic) transform positions it,
    so instance animation (reference src/lib.rs:1382-1689) is a pure array
    update of ``object_model``/``object_normal``.
    """

    # --- vertices (V rows, padded) ---
    position: Array        # (V, 3) f32 object-space position
    uv: Array              # (V, 2) f32
    normal: Array          # (V, 3) f32
    tangent: Array         # (V, 3) f32  (averaged per-triangle TBN, see io/)
    bitangent: Array       # (V, 3) f32
    vertex_object: Array   # (V,) i32 object id per vertex

    # --- triangles (T rows, Morton-sorted, padded to a CHUNK_SIZE multiple) ---
    tri_idx: Array         # (T, 3) i32 vertex indices
    tri_mat: Array         # (T,) i32 material id
    tri_valid: Array       # (T,) bool  False for padding rows

    # --- objects = (model, instance) pairs; dynamic transforms ---
    object_model: Array    # (O, 4, 4) f32 model matrix per object
    object_normal: Array   # (O, 3, 3) f32 normal matrix per object

    # --- materials / textures ---
    # Per-texture block-window tables: each texture is tiled into
    # 6×4-texel blocks whose Repeat-wrapped 7×5 windows (35 texels × RGB
    # = 105 lanes) form one 128-lane row — a pixel's whole 2×2 bilinear
    # footprint lives in ONE gathered row per texture (filtering
    # accumulates in f32 — see ops/sampling.py).  Dtypes: diffuse is
    # sqrt-encoded u8 (decode = v²/65025, ~bf16 accuracy at half the
    # bytes); normal is raw unorm at SOURCE depth — u8 / u16 / f32,
    # mirroring reference src/texture.rs:113-129 format selection.
    tex_diffuse: Array    # (R, 128) u8, round(sqrt(linear RGB)·255)
    tex_normal: Array     # (R, 128) u8/u16/f32 raw normal-map RGB
    mat_blk_base: Array   # (M,) i32 first block row of each material
    mat_blk_w: Array      # (M,) i32 blocks per texture row (= ceil(w/6))
    mat_tex_size: Array   # (M, 2) i32 (w, h) texels (normal maps are
    #                       resampled to the diffuse resolution at load)
    # Combined diffuse+normal table (all-u8 scenes): 3×4-texel blocks,
    # 4×5 window × 6 channels = 120 lanes — ONE gather serves both
    # textures (ops/sampling.sample_materials_combined).  When non-empty
    # it REPLACES tex_diffuse/tex_normal (which are then (0, 128)) and
    # mat_blk_base/mat_blk_w use its 3-texel-wide block geometry.
    # Scenes with u16/f32 normal maps keep the separate tables (source
    # bit depth preserved, reference src/texture.rs:113-129).
    tex_combined: Array = _np.zeros((0, 128), _np.uint8)
    # Static per-triangle material-parameter record lanes, planar (6, T):
    # [mat, tex_w, tex_h, blk_base_hi, blk_base_lo, blk_w] — material
    # assignment never changes after scene build, so the per-frame record
    # assembly (ops/interpolate.build_tri_records*) reuses this instead
    # of re-gathering 4 × T rows every frame.  (0, 6) = compute on the
    # fly (hand-built test scenes).
    tri_extra: Array = _np.zeros((0, 6), _np.float32)
    # Corner-major static geometry (ops/vertex.run_vertex_stage_corners):
    # per-corner planes expanded over tri_idx at build time, so the
    # per-frame geometry stage needs NO corner row gathers (the gather
    # pattern is static).  Layout: row (corner·ncomp + comp, T).  Empty =
    # absent (hand-built scenes fall back to the vertex-major path).
    corner_pos: Array = _np.zeros((0, 0), _np.float32)       # (9, T)
    corner_uv: Array = _np.zeros((0, 0), _np.float32)        # (6, T)
    corner_normal: Array = _np.zeros((0, 0), _np.float32)    # (9, T)
    corner_tangent: Array = _np.zeros((0, 0), _np.float32)   # (9, T)
    corner_bitangent: Array = _np.zeros((0, 0), _np.float32)  # (9, T)
    tri_object: Array = _np.zeros((0,), _np.int32)           # (T,) object id

    @property
    def num_vertices(self) -> int:
        return self.position.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_idx.shape[0]

    @property
    def num_chunks(self) -> int:
        return self.tri_idx.shape[0] // CHUNK_SIZE


class CameraState(NamedTuple):
    """FPS camera pose (reference src/camera.rs:18-54)."""

    position: Array  # (3,) f32
    yaw: Array       # () f32 radians
    pitch: Array     # () f32 radians


class MovableLight(NamedTuple):
    """The IJKL-movable point light (reference src/lib.rs:431-446)."""

    position: Array  # (3,) f32
    color: Array     # (3,) f32
    range: Array     # () f32
    yaw: Array       # () f32 (movement basis, reference src/light.rs:266-270)


class PointLights(NamedTuple):
    """Storage-buffer point light array (reference src/light.rs:42-49).

    Padded to a static count; padding entries use color == 0 which contributes
    exactly zero (the reference itself seeds one black dummy light,
    src/lib.rs:453-460).
    """

    position: Array  # (P, 3) f32
    color: Array     # (P, 3) f32
    range: Array     # (P,) f32


class DirectionalLight(NamedTuple):
    """Rotatable sun with shadow mapping (reference src/light.rs:51-78)."""

    color: Array             # (3,) f32
    direction: Array         # (3,) f32
    distance: Array          # () f32, default -2000
    intensity: Array         # () f32, default 2 (shader hardcodes 10/0.5 —
    #                          kept for uniform-layout parity)
    shadow_scene_size: Array  # () f32, default 3000


class Lights(NamedTuple):
    movable: MovableLight
    points: PointLights
    directional: DirectionalLight


class FrameState(NamedTuple):
    """Everything dynamic that the jitted frame function consumes."""

    camera: CameraState
    lights: Lights
    object_model: Array   # (O, 4, 4) — overrides Scene.object_model (animation)
    object_normal: Array  # (O, 3, 3)
    frame_times_ms: Array  # (256,) ring buffer for the Debug overlay graph
    #                        (reference src/frametime.rs:18-31)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) render settings → one XLA executable per value."""

    width: int = 1440            # reference default window (src/lib.rs:2056)
    height: int = 1080
    mode: RenderMode = RenderMode.LIT_SHADOW  # initial mode (src/lib.rs:1033)
    hdr: bool = False
    # Camera projection (reference src/lib.rs:384)
    fovy_deg: float = 45.0
    znear: float = 0.1
    zfar: float = 10000.0
    # Shadow map (reference src/lib.rs:738-758)
    shadow_dim: int = 2048
    # Depth bias of the shadow pipeline (reference src/lib.rs:896-900)
    shadow_bias_constant: float = 2.0
    shadow_bias_slope: float = 2.0
    # Clear color (reference src/lib.rs:1761-1768)
    clear_color: tuple = (0.1, 0.2, 0.3)
    # Debug overlay source (Key1 toggle, reference src/lib.rs:1282-1327)
    debug_texture: DebugTexture = DebugTexture.SCENE_DEPTH
    # --- rasterizer (no reference analog).  "tile" = the binned tile
    # kernel (ops/raster_tiles.py, GPU), "xla" = the brute-force oracle
    # (ops/raster_xla.py, CPU).  kanirenderer_tpu.backend.render_config
    # picks the backend and tile shapes from the JAX platform; these
    # defaults are sized for small CPU test frames. ---
    raster_backend: str = "xla"
    # Run the tile kernel through the Pallas interpreter: for tests of the
    # "tile" backend on a machine without a GPU.  Never set implicitly.
    interpret: bool = False
    tile_h: int = 8
    tile_w: int = 128
    shadow_tile_h: int = 16
    max_tiles_per_chunk: int = 64   # bbox expansion slots before "global" bin
    max_global_chunks: int = 128    # chunks binned to every tile
    # Reuse the shadow map across frames while sun and geometry are static
    # (the steady state of the interactive loop, which re-renders the PCF
    # table on the frame the light changes — runtime/loop.py).  False =
    # the reference's fresh-per-frame behavior (src/lib.rs:1721).
    cache_shadow_map: bool = True
    # Deferred pipeline (the reference stubbed it, src/lib.rs:730-736):
    # G-buffer write + world-space deferred lighting instead of the
    # forward tangent-space path.  Applies to LIT/LIT_SHADOW/DEBUG modes.
    deferred: bool = False
    # Emit the frame in its real surface format instead of f32: uint8
    # for LDR (Rgba8UnormSrgb) / float16 for HDR (Rgba16Float) — the
    # reference's surface selection (src/lib.rs:321-329).  Quantization
    # happens on-device (LDR path identical to runtime/display.to_uint8),
    # so the host present fetch moves 4x/2x less data and skips the
    # host-side convert; the interactive loop enables this.  f32 default
    # keeps analysis/tests on the full-precision encoded image.
    output_u8: bool = False
    # Present-path preview scale: emit the frame box-downsampled by this
    # factor (1 = off) to cut the device→host present transfer p²-fold.
    # The render stays full resolution (depth picking and goldens see
    # full res); the host sink upscales (runtime/loop.py).  No reference
    # analog.
    present_scale: int = 1
    wire_thresh_px: float = 0.7     # wireframe edge half-width in pixels

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def padded_width(self) -> int:
        return self.tiles_x * self.tile_w

    @property
    def padded_height(self) -> int:
        return self.tiles_y * self.tile_h

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def default_lights(num_point_lights: int = 1) -> Lights:
    """Initial light rig (reference src/lib.rs:431-514)."""
    movable = MovableLight(
        position=jnp.array([0.0, 100.0, 0.0], jnp.float32),
        color=jnp.array([20.0, 20.0, 20.0], jnp.float32),
        range=jnp.float32(256.0),
        yaw=jnp.float32(jnp.deg2rad(-90.0)),
    )
    # One far-away black dummy light, like the reference's seed entry
    # (src/lib.rs:453-460); extra slots stay black (zero contribution).
    pos = jnp.zeros((num_point_lights, 3), jnp.float32)
    pos = pos.at[:].set(jnp.array([99999.0, 999999.0, 99999.0], jnp.float32))
    points = PointLights(
        position=pos,
        color=jnp.zeros((num_point_lights, 3), jnp.float32),
        range=jnp.zeros((num_point_lights,), jnp.float32),
    )
    directional = DirectionalLight(
        color=jnp.array([1.0, 1.0, 1.0], jnp.float32),
        direction=jnp.array([0.0, -0.9902682, -0.1391731], jnp.float32),
        distance=jnp.float32(-2000.0),
        intensity=jnp.float32(2.0),
        shadow_scene_size=jnp.float32(3000.0),
    )
    return Lights(movable=movable, points=points, directional=directional)


def spawn_point_lights(num: int, rng=None) -> PointLights:
    """The reference's (disabled) random light spawner made real
    (src/lib.rs:453-512): slot 0 is the far black dummy light; slots
    1..num-1 are RED lights (color [10,0,0], range 256) at random
    positions x,z ∈ [-1000, 1000), y ∈ [10, 15); with num >= 50 a GREEN
    and a BLUE set of ``num`` lights each are appended
    (src/lib.rs:480-509) — 3·num lights total, as the reference would.
    """
    import numpy as np
    rng = rng or np.random.RandomState(0)

    def rand_pos(n):
        p = np.empty((n, 3), np.float32)
        p[:, 0] = rng.uniform(-1000.0, 1000.0, n)
        p[:, 1] = rng.uniform(10.0, 15.0, n)
        p[:, 2] = rng.uniform(-1000.0, 1000.0, n)
        return p

    num = max(int(num), 1)
    pos = rand_pos(num)
    pos[0] = [99999.0, 999999.0, 99999.0]          # the dummy seed light
    col = np.tile(np.array([10.0, 0.0, 0.0], np.float32), (num, 1))
    col[0] = 0.0
    rngs = np.full(num, 256.0, np.float32)
    rngs[0] = 0.0
    if num >= 50:
        pos = np.concatenate([pos, rand_pos(num), rand_pos(num)])
        col = np.concatenate([
            col,
            np.tile(np.array([0.0, 10.0, 0.0], np.float32), (num, 1)),
            np.tile(np.array([0.0, 0.0, 10.0], np.float32), (num, 1))])
        rngs = np.concatenate([rngs, np.full(2 * num, 256.0, np.float32)])
    return PointLights(position=jnp.asarray(pos), color=jnp.asarray(col),
                       range=jnp.asarray(rngs))


def default_camera() -> CameraState:
    """Initial pose (reference src/lib.rs:382)."""
    return CameraState(
        position=jnp.array([0.0, 5.0, 10.0], jnp.float32),
        yaw=jnp.float32(jnp.deg2rad(-90.0)),
        pitch=jnp.float32(jnp.deg2rad(-20.0)),
    )


def frame_state(scene: Scene, camera: CameraState, lights: Lights,
                frame_times_ms: Array | None = None) -> FrameState:
    if frame_times_ms is None:
        frame_times_ms = jnp.zeros(256, jnp.float32)
    return FrameState(camera=camera, lights=lights,
                      object_model=scene.object_model,
                      object_normal=scene.object_normal,
                      frame_times_ms=frame_times_ms)
