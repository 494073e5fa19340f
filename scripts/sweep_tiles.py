"""Tile-shape sweep of the GPU raster kernel at the bench scene.

Builds ``sponza_standin_scene`` (257,040 triangles) at the bench pose,
then for each tile shape and warp count times the main raster at
1920×1080 and the depth raster of the 2048² shadow map: binning plus
kernel, and the kernel alone on precomputed bins.  The first shape is
also checked once against the brute-force oracle (ops/raster_xla.py).

    python scripts/sweep_tiles.py [--shapes 8x32,16x16] [--warps 2,4]
                                  [--out chiprun_out/sweep.json]

Needs a GPU; prints the card, one line per configuration, and writes
the table as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

SHAPES = [(16, 32), (8, 32), (8, 64), (16, 16), (32, 32), (16, 64)]
WARPS = [1, 2, 4]
STAGES = [1, 3]


def _time(fn, *args, reps=10):
    """(compile+first-run seconds, mean seconds per call over ``reps``)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=None,
                    help="comma-separated HxW tile shapes")
    ap.add_argument("--warps", default=None,
                    help="comma-separated warp counts")
    ap.add_argument("--out", default="chiprun_out/sweep.json")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        print("sweep_tiles: no GPU found", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print("card:", card.strip())

    import kanirenderer_tpu as kani
    from kanirenderer_tpu.backend import enable_compile_cache, render_config
    from kanirenderer_tpu.models.procedural import (bench_camera,
                                                    sponza_standin_scene)
    from kanirenderer_tpu.ops import binning, raster_tiles, raster_xla
    from kanirenderer_tpu.passes.frame import (camera_setup,
                                               render_shadow_geometry)
    enable_compile_cache()

    scene = sponza_standin_scene()
    state = kani.frame_state(scene, bench_camera(), kani.default_lights())
    base = render_config(width=1920, height=1080,
                         mode=kani.RenderMode.LIT_SHADOW)
    st = jax.block_until_ready(camera_setup(scene, state, base))
    sh_st, _ = jax.block_until_ready(
        render_shadow_geometry(scene, state, base.with_(
            raster_backend="xla")))
    print(f"triangles {int(np.asarray(scene.tri_valid).sum())}")

    shapes = SHAPES if args.shapes is None else [
        tuple(int(n) for n in s.split("x")) for s in args.shapes.split(",")]
    warps = WARPS if args.warps is None else [
        int(n) for n in args.warps.split(",")]
    # Pipeline stages only on the first shape.
    combos = [(th, tw, nw, STAGES[0]) for th, tw in shapes for nw in warps]
    combos += [(shapes[0][0], shapes[0][1], warps[0], ns)
               for ns in STAGES[1:]]
    rows = []
    for th, tw, nw, ns in combos:
        cfg = base.with_(tile_h=th, tile_w=tw, shadow_tile_h=th)
        tx, ty = cfg.tiles_x, cfg.tiles_y
        sdim = cfg.shadow_dim
        stx, sty = -(-sdim // tw), -(-sdim // th)

        def bins_main(s, cfg=cfg):
            return binning.bin_stream(s.bbox, cfg.tiles_x, cfg.tiles_y,
                                      cfg.tile_w, cfg.tile_h,
                                      cfg.max_tiles_per_chunk,
                                      cfg.max_global_chunks)

        def kern_main(s, b, cfg=cfg, nw=nw, ns=ns):
            return raster_tiles.raster_call(
                s.setup, b, cfg.tiles_x, cfg.tiles_y, cfg.tile_w,
                cfg.tile_h, depth_only=False, num_warps=nw,
                num_stages=ns)

        def kern_depth(s, b, cfg=cfg, nw=nw, ns=ns):
            return raster_tiles.raster_call(
                s.setup, b, -(-cfg.shadow_dim // cfg.tile_w),
                -(-cfg.shadow_dim // cfg.shadow_tile_h), cfg.tile_w,
                cfg.shadow_tile_h, depth_only=True, num_warps=nw,
                num_stages=ns)

        row = dict(tile_h=th, tile_w=tw, num_warps=nw, num_stages=ns,
                   tiles_main=tx * ty, tiles_shadow=stx * sty)
        try:
            bm = jax.jit(bins_main)
            bd = jax.jit(lambda s, cfg=cfg: raster_tiles.shadow_bins(s,
                                                                     cfg))
            row["bin_main_compile_s"], row["bin_main_ms"] = _time(bm, st)
            row["bin_shadow_compile_s"], row["bin_shadow_ms"] = \
                _time(bd, sh_st)
            b_main = bm(st)
            b_sh = bd(sh_st)
            row["overflow_main"] = int(b_main.overflow)
            row["overflow_shadow"] = int(b_sh.overflow)
            row["entries_main"] = int(np.asarray(b_main.header[1]).sum())
            row["entries_shadow"] = int(np.asarray(b_sh.header[1]).sum())
            km, kd = jax.jit(kern_main), jax.jit(kern_depth)
            row["kernel_main_compile_s"], row["kernel_main_ms"] = \
                _time(km, st, b_main)
            row["kernel_depth_compile_s"], row["kernel_depth_ms"] = \
                _time(kd, sh_st, b_sh)
            for k in list(row):
                if k.endswith("_ms"):
                    row[k] *= 1e3
        except Exception as e:  # keep sweeping; the row records why
            row["error"] = f"{type(e).__name__}: {str(e)[:2000]}"
        print(json.dumps(row), flush=True)
        rows.append(row)

    # One parity check of the first configuration against the oracle.
    th, tw = shapes[0]
    cfg = base.with_(tile_h=th, tile_w=tw, shadow_tile_h=th)
    vt = raster_tiles.rasterize(st, cfg)
    t0 = time.perf_counter()
    vx = jax.block_until_ready(raster_xla.rasterize_xla(st.setup, 1920, 1080))
    oracle_main_s = time.perf_counter() - t0
    zt = raster_tiles.rasterize_depth(sh_st, cfg)
    t0 = time.perf_counter()
    zx = jax.block_until_ready(raster_xla.rasterize_depth_xla(sh_st.setup,
                                                              2048))
    oracle_depth_s = time.perf_counter() - t0
    same = np.asarray(vt.tri) == np.asarray(vx.tri)
    parity = dict(
        tile=[th, tw],
        id_agree=float(same.mean()),
        dz_same_max=float(np.abs(np.asarray(vt.z) - np.asarray(vx.z))[same]
                          .max()),
        dbary_same_max=float(np.abs(np.asarray(vt.bary)
                                    - np.asarray(vx.bary))[same].max()),
        dz_diff_max=float(np.abs(np.asarray(vt.z) - np.asarray(vx.z))[~same]
                          .max()) if (~same).any() else 0.0,
        shadow_dz_max=float(np.abs(np.asarray(zt) - np.asarray(zx)).max()),
        covered=float((np.asarray(vx.tri) >= 0).mean()),
        oracle_main_first_s=oracle_main_s,
        oracle_depth_first_s=oracle_depth_s)
    print("parity", json.dumps(parity), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card.strip(), rows=rows, parity=parity), f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
