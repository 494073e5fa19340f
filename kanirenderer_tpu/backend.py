"""The decisions that depend on the machine, in one place.

* ``raster_backend``: the JAX platform picks the rasterizer — ``"gpu"``
  runs the binned tile kernel (ops/raster_tiles.py), ``"cpu"`` the
  brute-force XLA oracle (ops/raster_xla.py, the CPU test path); any
  other platform is an error, not a silent fallback.
* ``render_config``: a RenderConfig with that backend and its tile
  shapes.
* ``enable_compile_cache``: JAX's persistent compilation cache at a fixed
  path inside the checkout, unless ``JAX_COMPILATION_CACHE_DIR`` already
  names one.
"""

from __future__ import annotations

import os

import jax

from kanirenderer_tpu.core.types import RenderConfig

# Tile kernel shapes and binning caps for the GPU (scripts/sweep_tiles.py
# measures the alternatives; PERF.md records the sweep).  At 8×32 tiles a
# chunk of the bench scene spans up to 2,700 tiles; 256 expansion slots
# leave at most 27 chunks (WIREFRAME, both faces) for the global list.
GPU_RASTER = dict(tile_h=8, tile_w=32, shadow_tile_h=8,
                  max_tiles_per_chunk=256, max_global_chunks=128)

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def raster_backend(platform: str | None = None) -> str:
    """"tile" on a GPU, "xla" on the CPU; raises for anything else."""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform == "gpu":
        return "tile"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no rasterizer for JAX platform {platform!r}: "
                       "kanirenderer runs on 'gpu' or 'cpu'")


def render_config(platform: str | None = None, **overrides) -> RenderConfig:
    """RenderConfig for ``platform`` (default: JAX's first device), with
    ``overrides`` applied last."""
    backend = raster_backend(platform)
    kw = dict(GPU_RASTER) if backend == "tile" else {}
    kw["raster_backend"] = backend
    kw.update(overrides)
    return RenderConfig(**kw)


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at ``<checkout>/.jax_cache``
    and return that path.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
    already uses it: set nothing and return None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
