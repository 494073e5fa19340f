"""Benchmark: the sponza-scale stand-in at 1080p, LIT_SHADOW, on one GPU.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "fps", "detail": {...}}

The scene is the deterministic procedural stand-in matched to
sponza.obj's workload (257,040 triangles, 25 materials with diffuse and
normal textures; models/procedural.sponza_standin_scene).  The camera
flies through the courtyard from the bench pose.

Two shadow policies, in one process, in this order:

* fresh (the headline): the shadow map is re-rendered inside every
  frame, as the reference does (src/lib.rs:1721-1751);
* cached: the shadow map's PCF table is rendered once and reused while
  the sun and geometry are static — the interactive loop's steady state.

Each reports the median FPS of five timed passes after a warm-up.  The
script exits non-zero when JAX finds no GPU.

    python bench.py [FRAMES]
"""

import json
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print("card:", card, flush=True)

    import kanirenderer_tpu as kani
    from kanirenderer_tpu.backend import enable_compile_cache, render_config
    from kanirenderer_tpu.models.procedural import (bench_camera,
                                                    sponza_standin_scene)
    from kanirenderer_tpu.passes.frame import render_frame, render_shadow_table
    from kanirenderer_tpu.runtime.controllers import (CameraInputs,
                                                      update_camera_host)
    enable_compile_cache()

    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    frames = int(args[0]) if args else 30

    scene = sponza_standin_scene()
    lights = kani.default_lights()
    # The LDR surface as uint8, as the interactive loop emits it.
    cfg = render_config(width=1920, height=1080,
                        mode=kani.RenderMode.LIT_SHADOW, output_u8=True)

    # Precompute the deterministic camera path so the timed loop measures
    # rendering only.
    inputs = CameraInputs(forward=1.0, rotate_dx=6.0)
    cams = [bench_camera()]
    for _ in range(frames):
        cams.append(update_camera_host(cams[-1], inputs, 1.0 / 60.0))
    states = [kani.frame_state(scene, c, lights) for c in cams[1:]]

    def flythrough(n, table=None):
        """Seconds for n frames, one completion sync at the end."""
        outs = None
        t0 = time.perf_counter()
        for k in range(n):
            outs = render_frame(scene, states[k % len(states)], cfg,
                                shadow_table=table)
        outs.image.block_until_ready()
        return time.perf_counter() - t0

    def passes(table=None):
        flythrough(3, table)
        return [frames / flythrough(frames, table) for _ in range(5)]

    fresh = passes()
    table = render_shadow_table(scene, kani.frame_state(
        scene, cams[0], lights), cfg)
    cached = passes(table)

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    tris = int(np.asarray(scene.tri_valid).sum())
    result = {
        "metric": "fps_1080p_sponza_standin_lit_shadow_fresh",
        "value": median(fresh),
        "unit": "fps",
        "detail": {
            "card": card,
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "frames": frames,
            "triangles": tris,
            "resolution": f"{cfg.width}x{cfg.height}",
            "backend": cfg.raster_backend,
            "tile": [cfg.tile_h, cfg.tile_w],
            "protocol": "median of 5 timed passes after a 3-frame warm-up",
            "fresh_passes_fps": fresh,
            "cached_fps": median(cached),
            "cached_passes_fps": cached,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
