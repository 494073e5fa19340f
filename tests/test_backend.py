"""The machine-dependent decisions of kanirenderer_tpu.backend."""

import os

import jax
import pytest

from kanirenderer_tpu import backend


@pytest.mark.parametrize("platform, want", [("cpu", "xla"), ("gpu", "tile"),
                                            ("rocm", None)])
def test_raster_backend_per_platform(platform, want):
    if want is None:
        with pytest.raises(RuntimeError, match="no rasterizer"):
            backend.raster_backend(platform)
        with pytest.raises(RuntimeError):
            backend.render_config(platform)
        return
    assert backend.raster_backend(platform) == want
    cfg = backend.render_config(platform, width=64)
    assert cfg.raster_backend == want and cfg.width == 64
    assert not cfg.interpret
    if want == "tile":
        assert (cfg.tile_h, cfg.tile_w) == (backend.GPU_RASTER["tile_h"],
                                            backend.GPU_RASTER["tile_w"])


def test_default_platform_is_the_first_device():
    assert backend.raster_backend() == "xla"   # the tests run on the CPU
    assert backend.render_config().raster_backend == "xla"


def test_compile_cache_respects_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.enable_compile_cache() is None
    assert calls == []


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = backend.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
