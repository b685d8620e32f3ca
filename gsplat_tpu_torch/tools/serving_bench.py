"""Serving benchmark: forward-only render frames/s at 1M Gaussians, 1080p.

Port of scripts/serving_bench.py. Serving and viewer workloads run the
forward path only: no backward d-table, no gradient reduction, and the pair
table may be the packed 8-column layout (`--pack`, render's attr_pack:
rgb and opacity as bf16 pairs, kept out of training by default but meant
for read-only inference). For the sparse (2.25 tile pairs a Gaussian) and
dense (33) scenes of tools/bench_scene.py at tile 32, chunk 128, it fits
the budgets by the reference's probes (the kept count from a binning at
the scene's pair budget, then the saturation cull's survivors at that kept
budget, the cull used where they are fewer than half the kept pairs; the
fits are render/budgets.py's), then
times synced frames (the best of --iters, each ended by a read of one
pixel) and pipelined frames (10 renders queued, then one read; their mean).

    python -m gsplat_tpu_torch.tools.serving_bench [--pack] [--iters 8]

It prints one JSON line: the reference's keys (n_gaussians, resolution,
attr_pack, device, {sparse,dense}_{ms,fps,pipelined_ms,pipelined_fps}) and
the card's power limit (nvidia-smi). `--device cpu` runs the kernels' plain
versions at a size given by --n, --size and the budgets: a smoke test, not a
measurement.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import List, Optional

import torch

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.render import budgets
from gsplat_tpu_torch.tools.bench_scene import scene_on_device

TILE, CHUNK = 32, 128
# scene name -> (tile pairs a Gaussian, pair budget): scripts/serving_bench.py
SCENES = {"sparse": (2.25, 5 << 19), "dense": (33.0, 5 << 23)}


def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi gives it, or None without one."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def sat_survivors(g, cam, pair_budget, kept):
    """The reference's second probe binning: the saturation cull's survivor
    rows at the fitted pair budget, with a sat budget of the kept one."""
    from gsplat_tpu_torch.render.binning import bin_gaussians
    from gsplat_tpu_torch.render.project import project_gaussians

    with torch.no_grad():
        p = project_gaussians(g, cam)
        b = bin_gaussians(p.mean2d, p.radius, p.depth, width=cam.width, height=cam.height,
                          tile_size=TILE, chunk=CHUNK, cull_conic=p.conic,
                          cull_opacity=p.opacity, pair_budget=pair_budget, kept_budget=kept,
                          sat_budget=kept)
        return int(b.n_sat)


def time_render(cam, g, bg, *, iters, **kw):
    """(best synced frame s, mean pipelined frame s) of render(**kw)."""
    from gsplat_tpu_torch.render.render import render

    def frame():
        return render(cam, g, bg, tile_size=TILE, chunk=CHUNK, **kw)

    with torch.no_grad():
        out = frame()
        if int(out.n_dropped) != 0:
            raise RuntimeError(f"the fitted budgets dropped {int(out.n_dropped)} pairs")
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            float(frame().image[0, 0, 0])
            best = min(best, time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(10):
            out = frame()
        float(out.image[0, 0, 0])
        pipe = (time.perf_counter() - t0) / 10
    return best, pipe


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="gsplat-tpu-torch-serving-bench")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--pack", action="store_true",
                    help="the 8-column bf16-packed pair table (read-only serving)")
    ap.add_argument("--size", type=int, nargs=2, default=[1920, 1080])
    ap.add_argument("--budgets", type=int, nargs=2,
                    default=[SCENES["sparse"][1], SCENES["dense"][1]],
                    help="pair budgets of the sparse and dense probes")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' names the CPU")
    ns = ap.parse_args(argv)

    device = resolve_device(ns.device)
    cuda = device.type == "cuda"
    w, h = ns.size
    out = {"n_gaussians": ns.n, "resolution": f"{w}x{h}", "attr_pack": bool(ns.pack),
           "device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "power_limit": power_limit() if cuda else None}
    for (name, (ppg, _)), budget in zip(SCENES.items(), ns.budgets):
        g, cam = scene_on_device(ns.n, w, h, target_pairs_per_gaussian=ppg, tile_size=TILE,
                                 device=device)
        bg = torch.zeros(3, dtype=torch.float32, device=device)
        n_pairs, n_culled = budgets.probe_pairs(g, cam, budget, tile_size=TILE, chunk=CHUNK)
        pair_fit, kept = budgets.fit_pair(n_pairs, budget, CHUNK), budgets.fit_kept(
            n_pairs, n_culled, CHUNK)
        n_kept = n_pairs - n_culled
        n_sat = sat_survivors(g, cam, pair_fit, kept)
        sat = budgets.fit_sat(n_sat, n_kept, CHUNK)
        print(f"{name}: pairs {n_pairs} kept {n_kept} sat {n_sat}", file=sys.stderr,
              flush=True)
        best, pipe = time_render(cam, g, bg, iters=ns.iters, pair_budget=pair_fit,
                                 kept_budget=kept, sat_budget=sat,
                                 attr_pack=True if ns.pack else None)
        out[f"{name}_ms"] = best * 1e3
        out[f"{name}_fps"] = 1.0 / best
        out[f"{name}_pipelined_ms"] = pipe * 1e3
        out[f"{name}_pipelined_fps"] = 1.0 / pipe
        del g, cam
        if cuda:
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
