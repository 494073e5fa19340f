"""Smoke test of the renderer's main path on one GPU (``--multi``: four).

    python chip_smoke.py            # one card: the phases below
    python chip_smoke.py --multi    # four cards: the row-band mesh only

Phases, in one process (a failed check raises, and the script exits
non-zero):

1. device — a GPU is required; prints the card's name and power limit
   (``nvidia-smi``), the device kind and the JAX version;
2. compile — the tile kernel (ops/raster_tiles.py) in main form at
   1920×1080 and depth-only form at 2048² on the bench scene
   (``sponza_standin_scene``, 257,040 triangles), with compile times,
   and ``memory_analysis()`` of the fresh-shadow LIT_SHADOW frame;
3. parity — the kernel's visibility buffer and shadow map against the
   brute-force oracle (ops/raster_xla.py) on the same setup;
4. kernel vs XLA — the kernel and the oracle timed on the same inputs,
   and the whole fresh-shadow LIT_SHADOW frame with each backend;
5. main path — ``run_loop`` at 1920×1080 LIT_SHADOW with the shadow map
   re-rendered in every frame; one frame of UNLIT, LIT, WIREFRAME, DEBUG
   and deferred+HDR; the CLI on the default cube at 1440×1080.  Every
   image must be finite and not the flat clear colour, and binning must
   drop nothing.

The last line of standard output is the JSON device record; the measured
values also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"chip_smoke check failed: {what}")


def timed(fn, *args, reps: int) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``reps`` calls (one
    warm call first)."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def image_checks(img, clear_rgb, what: str) -> dict:
    """Finite, and not the flat clear colour; returns the stats."""
    import numpy as np
    a = np.asarray(img, np.float32)
    if np.asarray(img).dtype == np.uint8:
        a = a / 255.0
    check(bool(np.isfinite(a).all()), f"{what}: non-finite pixels")
    off = np.abs(a - np.asarray(clear_rgb, np.float32)).max(axis=-1) > 0.02
    stats = dict(shape=list(a.shape), mean=float(a.mean()),
                 std=float(a.std()), non_clear=float(off.mean()))
    check(stats["non_clear"] > 0.001,
          f"{what}: flat clear-colour image {stats}")
    return stats


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the 4-card row-band mesh phase only")
    args = ap.parse_args()

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    card = card_line()
    print("card:", card)
    print(f"device_kind: {devices[0].device_kind}  count: {len(devices)}  "
          f"jax {jax.__version__}", flush=True)

    sys.path.insert(0, REPO)
    import numpy as np
    import kanirenderer_tpu as kani
    from kanirenderer_tpu.backend import enable_compile_cache, render_config
    from kanirenderer_tpu.core.color import linear_to_srgb
    from kanirenderer_tpu.models.procedural import (bench_camera,
                                                    sponza_standin_scene)
    cache = enable_compile_cache()
    print("compile cache:", cache or os.environ.get("JAX_COMPILATION_CACHE_DIR"))

    results: dict = {"card": card,
                     "device_kind": devices[0].device_kind,
                     "count": len(devices)}
    t0 = time.perf_counter()
    scene = sponza_standin_scene()
    state = kani.frame_state(scene, bench_camera(), kani.default_lights())
    results["scene_build_s"] = time.perf_counter() - t0
    # Fresh shadow in every frame (reference parity, src/lib.rs:1721).
    cfg = render_config(width=1920, height=1080,
                        mode=kani.RenderMode.LIT_SHADOW,
                        cache_shadow_map=False, output_u8=True)
    clear_ldr = np.asarray(linear_to_srgb(np.asarray(cfg.clear_color,
                                                     np.float32)))

    if args.multi:
        results["multi"] = phase_multi(scene, state, cfg)
    else:
        phase_single(scene, state, cfg, clear_ldr, results)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = "chip_smoke_multi.json" if args.multi else "chip_smoke.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


def phase_single(scene, state, cfg, clear_ldr, results) -> None:
    import jax
    import numpy as np
    import kanirenderer_tpu as kani
    from kanirenderer_tpu.cli import main as cli_main
    from kanirenderer_tpu.io.image import decode_png
    from kanirenderer_tpu.ops import raster_tiles, raster_xla
    from kanirenderer_tpu.passes.frame import (camera_setup, render_frame,
                                               render_shadow_geometry)
    from kanirenderer_tpu.runtime.display import make_sink
    from kanirenderer_tpu.runtime.loop import Events, run_loop

    # --- 2. compile at real widths ---
    st = jax.block_until_ready(camera_setup(scene, state, cfg))
    sh_st, _ = jax.block_until_ready(render_shadow_geometry(
        scene, state, cfg.with_(raster_backend="xla")))
    t0 = time.perf_counter()
    raster_tiles.rasterize.lower(st, cfg).compile()
    results["compile_main_kernel_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    raster_tiles.rasterize_depth.lower(sh_st, cfg).compile()
    results["compile_depth_kernel_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame_exe = render_frame.lower(scene, state, cfg).compile()
    results["compile_frame_s"] = time.perf_counter() - t0
    mem = frame_exe.memory_analysis()
    results["frame_memory"] = {k: getattr(mem, k) for k in dir(mem)
                               if k.endswith("_in_bytes")}
    print("compile:", json.dumps({k: v for k, v in results.items()
                                  if k.startswith("compile")}))
    print("frame memory_analysis:", mem, flush=True)

    # --- 3. parity with the oracle ---
    vt = raster_tiles.rasterize(st, cfg)
    vx = raster_xla.rasterize_xla(st.setup, cfg.width, cfg.height)
    zt = raster_tiles.rasterize_depth(sh_st, cfg)
    zx = raster_xla.rasterize_depth_xla(sh_st.setup, cfg.shadow_dim)
    same = np.asarray(vt.tri) == np.asarray(vx.tri)
    dz = np.abs(np.asarray(vt.z) - np.asarray(vx.z))
    db = np.abs(np.asarray(vt.bary) - np.asarray(vx.bary)).max(axis=-1)
    parity = dict(
        id_agree=float(same.mean()),
        dz_same_max=float(dz[same].max()),
        dbary_same_max=float(db[same].max()),
        dz_differ_max=float(dz[~same].max()) if (~same).any() else 0.0,
        shadow_dz_max=float(np.abs(np.asarray(zt) - np.asarray(zx)).max()),
        covered=float((np.asarray(vx.tri) >= 0).mean()),
        overflow_main=int(vt.overflow))
    results["parity"] = parity
    print("parity:", json.dumps(parity), flush=True)
    check(parity["id_agree"] >= 0.999, "triangle ids agree on >= 99.9%")
    check(parity["dz_same_max"] <= 1e-6, "|dz| <= 1e-6 where ids agree")
    check(parity["dbary_same_max"] <= 1e-4, "|dλ| <= 1e-4 where ids agree")
    check(parity["dz_differ_max"] <= 1e-5, "|dz| <= 1e-5 where ids differ")
    check(parity["shadow_dz_max"] <= 1e-6, "shadow map |dz| <= 1e-6")
    check(parity["overflow_main"] == 0, "main binning overflow == 0")

    # --- 4. kernel against XLA ---
    timing = dict(
        kernel_main_ms=1e3 * timed(raster_tiles.rasterize, st, cfg, reps=20),
        kernel_depth_ms=1e3 * timed(raster_tiles.rasterize_depth, sh_st,
                                    cfg, reps=20),
        xla_main_ms=1e3 * timed(
            lambda s: raster_xla.rasterize_xla(s, cfg.width, cfg.height),
            st.setup, reps=2),
        xla_depth_ms=1e3 * timed(
            lambda s: raster_xla.rasterize_depth_xla(s, cfg.shadow_dim),
            sh_st.setup, reps=2),
        frame_tile_ms=1e3 * timed(frame_exe, scene, state, reps=10))
    cfg_x = cfg.with_(raster_backend="xla")
    timing["frame_xla_ms"] = 1e3 * timed(
        lambda sc, s: render_frame(sc, s, cfg_x), scene, state, reps=2)
    results["timing"] = timing
    print("kernel vs xla:", json.dumps(timing), flush=True)

    # --- 5. main path ---
    loop_frames = []

    class CheckSink:
        scales_preview = True

        def __init__(self):
            self.null = make_sink("null", None, cfg.width, cfg.height)

        def present(self, frame, view=None):
            loop_frames.append(image_checks(frame, clear_ldr, "run_loop"))
            self.null.present(frame, view=view)

        def close(self):
            self.null.close()

    # The sun rotates (R held) and the camera holds the default pose: a
    # moving camera would integrate the first frame's compile time as dt
    # and leave the courtyard.
    stats = run_loop(scene, [Events(held=frozenset({"r"}))] * 4, config=cfg,
                     sink=CheckSink(), max_frames=4)
    check(stats["frames"] == 4 and len(loop_frames) == 4,
          f"run_loop presented 4 frames ({stats['frames']})")
    results["run_loop"] = dict(frames=stats["frames"],
                               mean_ms=stats["mean_ms"], images=loop_frames)
    print("run_loop:", json.dumps(results["run_loop"]), flush=True)

    modes = {"unlit": dict(mode=kani.RenderMode.UNLIT),
             "lit": dict(mode=kani.RenderMode.LIT),
             "lit_shadow": dict(mode=kani.RenderMode.LIT_SHADOW),
             "wireframe": dict(mode=kani.RenderMode.WIREFRAME),
             "debug": dict(mode=kani.RenderMode.DEBUG),
             "deferred_hdr": dict(mode=kani.RenderMode.LIT_SHADOW,
                                  deferred=True, hdr=True)}
    results["modes"] = {}
    for name, kw in modes.items():
        mcfg = cfg.with_(output_u8=False, **kw)
        clear = (np.clip(np.asarray(mcfg.clear_color), 0, 1) if mcfg.hdr
                 else clear_ldr)
        out = render_frame(scene, state, mcfg)
        st_ = image_checks(out.image, clear, name)
        st_["raster_overflow"] = int(out.raster_overflow)
        check(st_["raster_overflow"] == 0, f"{name}: raster_overflow == 0")
        results["modes"][name] = st_
        print(f"mode {name}:", json.dumps(st_), flush=True)

    # The CLI at its default 1440×1080 on the default cube.  The default
    # camera sits inside the cube, so the fill modes show the reference's
    # flat clear colour (back faces culled); WIREFRAME draws both faces.
    # PNG frames hold no non-finite values by construction (uint8).
    results["cli"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for extra in ([], ["--mode", "wireframe"]):
            tag = extra[-1] if extra else "lit_shadow"
            out = os.path.join(tmp, f"cube_{tag}.png")
            rc = cli_main(["", "opengl", "windowed", "hdr:false",
                           "--frames", "3", "--sink", "png", "--out", out,
                           "--quiet", *extra])
            check(rc == 0, f"cli {tag} exit code {rc}")
            pngs = sorted(p for p in os.listdir(tmp)
                          if p.startswith(f"cube_{tag}"))
            check(len(pngs) == 3, f"cli {tag} wrote 3 frames ({pngs})")
            imgs = [decode_png(open(os.path.join(tmp, p), "rb").read())
                    for p in pngs]
            for img in imgs:
                check(img.shape == (1080, 1440, 3), f"cli {tag} frame shape")
            if extra:
                # The scripted fly-through integrates wall-clock dt, so
                # after the first (compiling) frame the camera may have
                # left the cube; the first frame is at the default pose.
                stats = [image_checks(imgs[0], clear_ldr, f"cli {tag}")]
            else:
                # Exactly the clear colour: what the reference shows.
                want = np.round(clear_ldr * 255.0)
                check(all(np.abs(i.astype(np.float32) - want).max() <= 1
                          for i in imgs), "cli lit_shadow: clear colour")
                stats = [dict(shape=list(i.shape), flat_clear=True)
                         for i in imgs]
            results["cli"][tag] = stats
            print(f"cli {tag}:", json.dumps(stats[-1]), flush=True)


def phase_multi(scene, state, cfg) -> dict:
    """Interleaved row bands on four cards vs one card, fresh shadow."""
    import jax
    import numpy as np
    from kanirenderer_tpu.parallel.mesh import (deinterleave_rows, make_mesh,
                                                render_frame_sharded)
    from kanirenderer_tpu.passes.frame import render_frame

    devices = jax.devices()
    check(len(devices) == 4, f"--multi needs 4 GPUs, found {len(devices)}")
    mesh = make_mesh(devices)
    fcfg = cfg.with_(output_u8=False)

    def sharded(scene, state):
        return render_frame_sharded(scene, state, fcfg, mesh,
                                    interleave=True)

    t0 = time.perf_counter()
    out_sh = jax.block_until_ready(sharded(scene, state))
    first_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_one = jax.block_until_ready(render_frame(scene, state, fcfg))
    first_one = time.perf_counter() - t0
    img_sh = deinterleave_rows(np.asarray(out_sh.image), len(devices),
                               fcfg.tile_h, fcfg.height)
    img_one = np.asarray(out_one.image)
    diff = np.abs(img_sh - img_one)
    multi = dict(
        mean_abs_diff=float(diff.mean()), max_abs_diff=float(diff.max()),
        first_call_s=dict(sharded=first_sh, one_card=first_one),
        frame_ms_4cards=1e3 * timed(sharded, scene, state, reps=10),
        frame_ms_1card=1e3 * timed(
            lambda sc, s: render_frame(sc, s, fcfg), scene, state, reps=10),
        finite=bool(np.isfinite(img_sh).all()))
    print("multi:", json.dumps(multi), flush=True)
    check(multi["finite"], "sharded image finite")
    check(multi["mean_abs_diff"] <= 0.05,
          "sharded vs one-card mean |diff| <= 0.05")
    return multi


if __name__ == "__main__":
    sys.exit(main())
