"""Headline benchmark: pixels/s a card, forward + backward, 1M Gaussians at 1080p.

Port of bench.py. For two densities of the bench scene (tools/bench_scene.py,
its geometry at the fixed 32-px reference tile whatever --tile_size is:
sparse, 2.25 tile pairs a Gaussian, pair budget 5 << 19; dense, 33, 5 << 23)
it runs one training step (tools/bench_scene.py::fwd_bwd: render, L1 +
D-SSIM at lambda 0.2, the gradients of every group) in up to three passes:

- plain: the scene's pair budget, the tight tile cull as bench.py asks;
- kept: the pair, kept and contrib budgets fitted from the plain pass's
  counts and a binning probe's culled count, where the probe culled any
  pair;
- sat: the saturation bound cull at a budget fitted from a probe render's
  survivor rows, where they fall a chunk short of the kept budget
  (render/budgets.py holds bench.py's fits).

Each pass is timed synced (the best of `iters` steps, each ended by
torch.cuda.synchronize) and pipelined (10 steps queued back to back between
two synchronisations, divided by 10), by the host clock and by CUDA events
over the same window (the keys ending in `_device_ms`).

    python3 bench_torch.py [--tile_size 32] [--chunk 128] [--skip_dense] [--no_cull]
    python3 bench_torch.py --device cpu [--n 200 --size 64 48]

The last line of stdout is one JSON object with bench.py's keys and their
meaning, but:

- `vs_baseline` prices the head pixels/s against HBM_BW / (192 bytes x pairs
  a pixel) with the card's bandwidth (`PEAKS`); bench.py's `vpu_sol_ms`,
  `dense_vpu_sol_ms`, `vs_vpu_sol` and `vs_vpu_sol_synced` become
  `fp32_sol_ms`, `dense_fp32_sol_ms`, `vs_fp32_sol` and
  `vs_fp32_sol_synced`: the composited pair-pixels at C_OPS_FWD_BWD
  operations each over the card's fp32 rate. On a card that `PEAKS` does
  not name, and on the CPU, these five are null;
- `first_call_s` stands where bench.py's `compile_s` stood: the sparse plain
  pass's first step with the kernel builds before it (nvcc, on a checkout's
  first run only); the port compiles nothing a pass;
- added: `device`, `backend` ("cuda" or "cpu"), `power_limit` (nvidia-smi),
  `peak_memory_bytes` and `dense_peak_memory_bytes` (max_memory_allocated
  of each scene's passes), `n_dropped` and `dense_n_dropped` (the plain
  pass's; the fitted passes raise on a dropped pair), and a `_device_ms` key
  beside every timed one;
- numbers are not rounded.

Without a card, and no --device, it raises. `--device cpu` is bench.py's
smoke branch (2000 Gaussians at 256x256, chunk 32, tile 16, budgets 1 << 14
and 1 << 17, no kept or sat pass) under the metric name
`pixels_per_s_cpu_smoke`; --n and --size shrink it further. Progress lines
go to stderr.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.render import budgets
from gsplat_tpu_torch.tools.bench_scene import fwd_bwd, scene_on_device
from gsplat_tpu_torch.tools.serving_bench import power_limit

METRIC = "pixels_per_s_per_chip_fwd_bwd_1M_gaussians_1080p"
CPU_METRIC = "pixels_per_s_cpu_smoke"
SCENE_TILE = 32          # the tile the scene's splat radii are sized for
PIPELINE = 10            # steps queued between two synchronisations
# a card's name (a part of torch.cuda.get_device_name) -> (HBM bytes/s, fp32
# FLOP/s outside the tensor cores): NVIDIA's H100 SXM5 data sheet
PEAKS = {"H100 80GB HBM3": (3.35e12, 67e12)}
# HBM bytes a live pair must move: 64 into the forward sweep, 64 in and 64
# of gradients out of the backward
SOL_BYTES_PER_PAIR = 192
# f32 operations a composited pair-pixel: K2's 31 and K3's 65 (chip_smoke.py)
C_OPS_FWD_BWD = 96
# (name, tile pairs a Gaussian, pair budget, iters) of the card's and the CPU's runs
CARD_N, CARD_SIZE = 1_000_000, (1920, 1080)
CARD_CONFIGS = (("sparse", 2.25, 5 << 19, 5), ("dense", 33.0, 5 << 23, 3))
CPU_N, CPU_SIZE, CPU_CHUNK, CPU_TILE = 2_000, (256, 256), 32, 16
CPU_CONFIGS = (("sparse", 4.0, 1 << 14, 2), ("dense", 36.0, 1 << 17, 2))
# the timed keys of a config; each has a `_device_ms` partner
TIMED = ("train_step_ms", "step_ms", "plain_step_ms", "kept_step_ms", "sat_step_ms",
         "pipelined_step_ms", "kept_pipelined_ms", "sat_pipelined_ms")


def device_key(key: str) -> str:
    """The `_device_ms` partner of a timed key."""
    return key[:-len("_ms")] + "_device_ms"


def time_pass(step: Callable[[], object], iters: int, device: torch.device) -> Dict:
    """bench.py::_time_pass -> {"synced_ms": the best of `iters` steps, each
    synchronised; "pipelined_ms": PIPELINE steps queued between two
    synchronisations, a step's share}, each with its "_device_ms" partner:
    CUDA events over the same window (None on the CPU)."""
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def window(fn):
        """(host ms, device ms) of fn() between two synchronisations."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
        sync()
        t0 = time.perf_counter()
        if cuda:
            ev[0].record()
        fn()
        if cuda:
            ev[1].record()
        sync()
        return (time.perf_counter() - t0) * 1e3, ev[0].elapsed_time(ev[1]) if cuda else None

    synced = [window(step) for _ in range(iters)]

    def queued():
        for _ in range(PIPELINE):
            step()

    host, dev = window(queued)
    return {"synced_ms": min(h for h, _ in synced),
            "synced_device_ms": min(d for _, d in synced) if cuda else None,
            "pipelined_ms": host / PIPELINE,
            "pipelined_device_ms": dev / PIPELINE if cuda else None}


def _checked(label: str, result, contrib: Optional[int] = None):
    """A pass's first step: finite loss and gradients, and for a fitted pass
    (`contrib` given) no dropped pair and the composited slots within their
    budget (bench.py:194-197, 261-264) -> the step's result."""
    loss, out, grads = result
    bad = [k for k, v in grads.items() if not bool(torch.isfinite(v).all())]
    if not math.isfinite(float(loss)) or bad:
        raise RuntimeError(f"{label} pass: loss {float(loss)}, non-finite gradients {bad}")
    if contrib is not None and (int(out.n_dropped) != 0 or int(out.n_contrib) > contrib):
        raise RuntimeError(f"{label} pass: n_dropped {int(out.n_dropped)}, n_contrib "
                           f"{int(out.n_contrib)} of a budget of {contrib}")
    return result


def run_config(n, width, height, *, tile_size, chunk, pair_budget, iters, device,
               target_pairs_per_gaussian=4.0, tight_cull=True, auto_kept=False) -> Dict:
    """bench.py::run_config: the passes of one scene density -> {key: value}
    with the pass times under bench.py's names (a pass that did not run
    None), the counts, the sparse loss and first_call_s, n_dropped and
    peak_memory_bytes."""
    from gsplat_tpu_torch.render.render import render

    cuda = device.type == "cuda"
    print(f"building scene n={n} {width}x{height} target_ppg={target_pairs_per_gaussian}",
          file=sys.stderr, flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    g, cam = scene_on_device(n, width, height,
                             target_pairs_per_gaussian=target_pairs_per_gaussian,
                             tile_size=SCENE_TILE, device=device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)

    def step(**kw):
        return lambda: fwd_bwd(g, cam, bg, tile_size=tile_size, chunk=chunk, **kw)

    plain = step(pair_budget=pair_budget, tight_cull=tight_cull)
    print("first call of the plain pass", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    if cuda:
        from gsplat_tpu_torch import _build

        _build.build(host=())     # every kernel not yet built, nvcc in parallel
    loss, out, _ = _checked("plain", plain())
    n_pairs, n_culled = int(out.n_pairs), int(out.n_culled)
    n_contrib, n_dropped = int(out.n_contrib), int(out.n_dropped)
    first_call_s = time.perf_counter() - t0
    del out
    passes = {"plain": time_pass(plain, iters, device)}

    n_sat = 0
    if auto_kept:
        # the culled count: the probe turns the cull on where the plain
        # pass's budget left it off
        _, n_culled = budgets.probe_pairs(g, cam, pair_budget, tile_size=tile_size,
                                          chunk=chunk)
    if auto_kept and n_culled > 0:
        pair_fit = budgets.fit_pair_bench(n_pairs, pair_budget, chunk)
        kept = budgets.fit_kept(n_pairs, n_culled, chunk)
        contrib = budgets.fit_contrib(n_contrib)
        fitted = dict(pair_budget=pair_fit, kept_budget=kept, contrib_budget=contrib)
        print(f"kept-budget pass (pair_budget={pair_fit}, kept={kept}, contrib={contrib})",
              file=sys.stderr, flush=True)
        kept_step = step(tight_cull=tight_cull, **fitted)
        _checked("kept", kept_step(), contrib)
        passes["kept"] = time_pass(kept_step, iters, device)

        print("probing saturation bound cull", file=sys.stderr, flush=True)
        with torch.no_grad():
            probe = render(cam, g, bg, tile_size=tile_size, chunk=chunk, tight_cull=True,
                           sat_budget=pair_fit, **fitted)
            n_sat, probe_dropped = int(probe.n_sat), int(probe.n_dropped)
            del probe
        sat = budgets.fit_sat_bench(n_sat, probe_dropped, kept, chunk)
        if sat is not None:
            print(f"sat-cull pass (sat={sat} of kept={kept})", file=sys.stderr, flush=True)
            sat_step = step(tight_cull=True, sat_budget=sat, **fitted)
            _checked("sat", sat_step(), contrib)
            passes["sat"] = time_pass(sat_step, iters, device)

    del g, cam
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    for label, t in passes.items():
        print(f"{label} pass: synced {t['synced_ms']:.3f} ms, pipelined "
              f"{t['pipelined_ms']:.3f} ms", file=sys.stderr, flush=True)

    def pass_ms(label, key):
        t = passes.get(label)
        return (None, None) if t is None else (t[key], t[device_key(key)])

    res = {"pairs": n_pairs, "pairs_per_pixel": n_pairs / (width * height),
           "culled": n_culled, "contrib": n_contrib, "sat_kept": n_sat,
           "loss": float(loss), "first_call_s": first_call_s, "n_dropped": n_dropped,
           "peak_memory_bytes": peak}
    for key, label, what in (("plain_step_ms", "plain", "synced_ms"),
                             ("kept_step_ms", "kept", "synced_ms"),
                             ("sat_step_ms", "sat", "synced_ms"),
                             ("pipelined_step_ms", "plain", "pipelined_ms"),
                             ("kept_pipelined_ms", "kept", "pipelined_ms"),
                             ("sat_pipelined_ms", "sat", "pipelined_ms")):
        res[key], res[device_key(key)] = pass_ms(label, what)
    # the headline step is the best pass (bench.py:374-387): synced for
    # step_ms, pipelined (the trainer's cadence) for train_step_ms
    best = min(passes.values(), key=lambda t: t["synced_ms"])
    pipe = min(passes.values(), key=lambda t: t["pipelined_ms"])
    pixels = width * height
    res.update(step_ms=best["synced_ms"], step_device_ms=best["synced_device_ms"],
               pix_per_s=pixels / (best["synced_ms"] / 1e3),
               train_step_ms=pipe["pipelined_ms"],
               train_step_device_ms=pipe["pipelined_device_ms"],
               train_pix_per_s=pixels / (pipe["pipelined_ms"] / 1e3))
    return res


def card_peaks(device: torch.device):
    """(HBM bytes/s, fp32 FLOP/s) of the card, or None (one line on stderr)
    for the CPU and for a card PEAKS does not name."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"
    for part, peaks in PEAKS.items():
        if part in name:
            return peaks
    print(f"no peak rates for {name}: vs_baseline and the fp32 shares are null",
          file=sys.stderr, flush=True)
    return None


# the keys each config prints, the dense ones with a "dense_" prefix (bench.py:402-450)
BOTH = ("train_step_ms", "step_ms", "plain_step_ms", "kept_step_ms", "sat_step_ms",
        "pairs_per_pixel", "culled", "contrib", "sat_kept", "pipelined_step_ms",
        "kept_pipelined_ms", "sat_pipelined_ms", "fp32_sol_ms", "peak_memory_bytes",
        "n_dropped")


def report(sparse: Dict, dense: Dict, *, metric, n, width, height, tile_size,
           device: torch.device) -> Dict:
    """The JSON object of bench.py:402-450 (the renamed and added keys in
    the module docstring) from the two configs' results."""
    cuda = device.type == "cuda"
    peaks = card_peaks(device)
    for cfg in (sparse, dense):
        cfg["fp32_sol_ms"] = None if peaks is None else \
            cfg["contrib"] * tile_size * tile_size * C_OPS_FWD_BWD / peaks[1] * 1e3
    head_ms, head_pix = sparse["train_step_ms"], sparse["train_pix_per_s"]
    vs = vs_fp32 = vs_fp32_synced = None
    if peaks is not None:
        sol_pix_per_s = peaks[0] / (SOL_BYTES_PER_PAIR * max(sparse["pairs_per_pixel"], 1e-9))
        vs = head_pix / sol_pix_per_s
        vs_fp32 = sparse["fp32_sol_ms"] / head_ms
        vs_fp32_synced = sparse["fp32_sol_ms"] / sparse["step_ms"]
    out = {"metric": metric, "value": head_pix, "value_pipelined": head_pix,
           "value_synced": sparse["pix_per_s"], "unit": "pixels/s", "vs_baseline": vs,
           "pairs": sparse["pairs"], "dense_pix_per_s": dense["pix_per_s"],
           "vs_fp32_sol": vs_fp32, "vs_fp32_sol_synced": vs_fp32_synced,
           "n_gaussians": n, "resolution": f"{width}x{height}", "tile_size": tile_size,
           "loss": sparse["loss"], "first_call_s": sparse["first_call_s"],
           "device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "backend": "cuda" if cuda else "cpu",
           "power_limit": power_limit() if cuda else None}
    for prefix, cfg in (("", sparse), ("dense_", dense)):
        for key in BOTH:
            out[prefix + key] = cfg[key]
            if key in TIMED:
                out[prefix + device_key(key)] = cfg[device_key(key)]
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="bench_torch.py", description=__doc__.split("\n")[0])
    ap.add_argument("--tile_size", type=int, default=None,
                    help="default: 32 on the card, 16 on the CPU")
    ap.add_argument("--chunk", type=int, default=None,
                    help="default: 128 on the card, 32 on the CPU")
    ap.add_argument("--skip_dense", action="store_true",
                    help="time the sparse scene only and report it for both")
    ap.add_argument("--no_cull", action="store_true",
                    help="the tight tile cull off, and with it the kept and sat passes")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' names the CPU (a smoke run)")
    ap.add_argument("--n", type=int, default=None, help="Gaussians (a smaller test run)")
    ap.add_argument("--size", type=int, nargs=2, default=None, metavar=("W", "H"),
                    help="image size (a smaller test run)")
    ns = ap.parse_args(argv)

    device = resolve_device(ns.device)
    cuda = device.type == "cuda"
    n = ns.n or (CARD_N if cuda else CPU_N)
    width, height = ns.size or (CARD_SIZE if cuda else CPU_SIZE)
    tile_size = ns.tile_size or (32 if cuda else CPU_TILE)
    chunk = ns.chunk or (128 if cuda else CPU_CHUNK)
    tight_cull = not ns.no_cull
    if not cuda:
        metric = CPU_METRIC
    elif (n, width, height) == (CARD_N, *CARD_SIZE):
        metric = METRIC
    else:
        metric = f"pixels_per_s_per_chip_fwd_bwd_{n}_gaussians_{width}x{height}"

    results = {}
    for name, ppg, budget, iters in CARD_CONFIGS if cuda else CPU_CONFIGS:
        if name == "dense" and ns.skip_dense:
            results[name] = results["sparse"]
            continue
        results[name] = run_config(
            n, width, height, tile_size=tile_size, chunk=chunk, pair_budget=budget,
            iters=iters, device=device, target_pairs_per_gaussian=ppg,
            tight_cull=tight_cull, auto_kept=tight_cull and cuda)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    print(json.dumps(report(results["sparse"], results["dense"], metric=metric, n=n,
                            width=width, height=height, tile_size=tile_size,
                            device=device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
