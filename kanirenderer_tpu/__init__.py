"""kanirenderer_tpu — a software mesh renderer in JAX for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``ourbunka/kanirenderer`` (a wgpu/Rust 3D mesh previewer): OBJ/MTL + texture
loading, an FPS camera, a movable point light, a rotatable directional light
with PCF shadow mapping, and five render modes (unlit / lit / lit+shadow /
wireframe / debug), plus the deferred pipeline the reference only stubbed.

The compute path is a jit-compiled visibility-buffer rasterizer (a binned
Pallas/Triton tile kernel + dense XLA shading).  See docs/ARCHITECTURE.md.
"""

from kanirenderer_tpu.core.types import (  # noqa: F401
    CHUNK_SIZE,
    CameraState,
    DebugTexture,
    DirectionalLight,
    FrameState,
    Lights,
    MovableLight,
    PointLights,
    RenderConfig,
    RenderMode,
    Scene,
    default_camera,
    default_lights,
    frame_state,
)

__version__ = "0.1.0"
