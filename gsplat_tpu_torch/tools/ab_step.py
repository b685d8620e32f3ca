"""A lean A/B timer of one fitted training-step configuration.

Port of scripts/ab_step.py. The bench scene (tools/bench_scene.py) is
binned once at the pair budget with the tight cull on, to fit the pair and
kept budgets, and stepped once with the d-table at the size that cannot
overflow, to fit the contrib budget (render/budgets.py's rules); then the
forward + backward at those budgets is timed: the best of --iters synced
steps, and 10 steps queued back to back between two synchronisations (the
loop's cadence). It prints one JSON line.
The JAX script's A/B levers are environment variables of its kernels; the
port has none, so the levers here are --chunk and --tile_size.

    python -m gsplat_tpu_torch.tools.ab_step [--chunk 128] [--tile_size 32]
        [--scene_tile 32] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import List, Optional

import torch

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.render import budgets
from gsplat_tpu_torch.tools.bench_scene import fwd_bwd, scene_on_device


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="gsplat-tpu-torch-ab-step")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--size", type=int, nargs=2, default=[1920, 1080])
    ap.add_argument("--tile_size", type=int, default=32)
    ap.add_argument("--scene_tile", type=int, default=0,
                    help="tile size the scene's splat radii target (default: "
                         "--tile_size); set it to 32 when A/B-ing --tile_size so "
                         "the scene stays fixed")
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--ppg", type=float, default=2.25)
    ap.add_argument("--pair_budget", type=int, default=5 << 19)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' names the CPU")
    ns = ap.parse_args(argv)

    device = resolve_device(ns.device)
    cuda = device.type == "cuda"
    w, h = ns.size
    chunk = ns.chunk
    g, cam = scene_on_device(ns.n, w, h, target_pairs_per_gaussian=ns.ppg,
                             tile_size=ns.scene_tile or ns.tile_size, device=device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    print("probing...", file=sys.stderr, flush=True)
    n_pairs, n_culled = budgets.probe_pairs(g, cam, ns.pair_budget, tile_size=ns.tile_size,
                                            chunk=chunk)
    pair_fit = budgets.chunk_fit(n_pairs, chunk)
    kept = budgets.fit_kept(n_pairs, n_culled, chunk)
    kw = dict(tile_size=ns.tile_size, chunk=chunk, pair_budget=pair_fit, kept_budget=kept)

    print("probing contrib...", file=sys.stderr, flush=True)
    _, out, _ = fwd_bwd(g, cam, bg, **kw)
    contrib = budgets.fit_contrib(out.n_contrib)
    kw["contrib_budget"] = contrib

    loss, out, grads = fwd_bwd(g, cam, bg, **kw)
    if int(out.n_dropped) != 0 or not math.isfinite(float(loss)) \
            or not all(bool(torch.isfinite(v).all()) for v in grads.values()):
        raise RuntimeError(f"fitted step: n_dropped {int(out.n_dropped)}, loss "
                           f"{float(loss)}, gradients finite: "
                           f"{all(bool(torch.isfinite(v).all()) for v in grads.values())}")
    best = float("inf")
    for _ in range(ns.iters):
        sync()
        t0 = time.perf_counter()
        fwd_bwd(g, cam, bg, **kw)
        sync()
        best = min(best, time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(10):
        fwd_bwd(g, cam, bg, **kw)
    sync()
    pipelined = (time.perf_counter() - t0) / 10
    print(json.dumps({
        "step_ms": round(best * 1e3, 3), "pipelined_ms": round(pipelined * 1e3, 3),
        "loss": round(float(loss), 5), "pairs": n_pairs, "kept": kept,
        "contrib": contrib, "chunk": chunk, "tile_size": ns.tile_size,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
