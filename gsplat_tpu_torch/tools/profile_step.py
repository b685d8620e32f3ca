"""A torch.profiler table of the training step's device operations.

Port of scripts/profile_step.py (which parses a jax.profiler xplane): one
forward + backward of the bench scene (tools/bench_scene.py; render, L1 +
D-SSIM, the gradients of every group), warmed up once, then `--steps` synced
steps under torch.profiler's CPU and CUDA tracing. It prints each device
operation's ms a step and launches a step, longest first, the device total
beside the host clock's, and the card's name.

    python -m gsplat_tpu_torch.tools.profile_step [--n 1000000] [--size 1920 1080]
        [--steps 2] [--tile_size 32] [--sat_budget 0] [--trace out.json]

On the CPU (`--device cpu`) the table lists the CPU operations instead: the
kernels' plain versions, no device time.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import torch

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.tools.bench_scene import fwd_bwd, scene_on_device


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="gsplat-tpu-torch-profile-step")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--size", type=int, nargs=2, default=[1920, 1080])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--tile_size", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--ppg", type=float, default=4.0,
                    help="target pairs per Gaussian (bench scene density)")
    ap.add_argument("--pair_budget", type=int, default=5 << 19)
    ap.add_argument("--kept_budget", type=int, default=0,
                    help="post-sort stage size (0 = pair_budget, no split)")
    ap.add_argument("--contrib_budget", type=int, default=0,
                    help="backward d-table size (0 = the size that cannot overflow)")
    ap.add_argument("--sat_budget", type=int, default=0,
                    help="saturation bound cull survivor budget (0 = off)")
    ap.add_argument("--top", type=int, default=45, help="rows of the table")
    ap.add_argument("--trace", default="", help="also write a Chrome trace here")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' names the CPU")
    ns = ap.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(ns.device)
    cuda = device.type == "cuda"
    w, h = ns.size
    g, cam = scene_on_device(ns.n, w, h, target_pairs_per_gaussian=ns.ppg,
                             tile_size=ns.tile_size, device=device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    kw = dict(tile_size=ns.tile_size, chunk=ns.chunk, pair_budget=ns.pair_budget,
              kept_budget=ns.kept_budget or None, contrib_budget=ns.contrib_budget or None,
              sat_budget=ns.sat_budget or None)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    loss, out, _ = fwd_bwd(g, cam, bg, **kw)     # warm-up: builds the kernels
    sync()
    print(f"loss {float(loss):.6f}, n_pairs {int(out.n_pairs)}, n_dropped "
          f"{int(out.n_dropped)}", file=sys.stderr, flush=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ns.steps):
            fwd_bwd(g, cam, bg, **kw)
            sync()
        wall = (time.perf_counter() - t0) * 1e3 / ns.steps
    if ns.trace:
        prof.export_chrome_trace(ns.trace)

    want = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    rows = [e for e in prof.key_averages()
            if e.device_type == want and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda e: -(e.self_device_time_total if cuda else e.self_cpu_time_total))
    total = sum((e.self_device_time_total if cuda else e.self_cpu_time_total)
                for e in rows) / 1e3 / ns.steps
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    print(f"== {name}: {len(rows)} operations, {total:.3f} ms a step of "
          f"{'device' if cuda else 'CPU self'} time; {wall:.3f} ms a step on the host clock "
          f"(synced, {ns.steps} steps, profiler on)")
    for e in rows[:ns.top]:
        t = (e.self_device_time_total if cuda else e.self_cpu_time_total) / 1e3 / ns.steps
        print(f"  {t:9.3f} ms  x{e.count // ns.steps:4d}  {e.key[:100]}")
    if cuda and total == 0:
        print("  (the profiler saw no device time: its CUDA tracing does not work here)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
