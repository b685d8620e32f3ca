#!/usr/bin/env python3
"""Parent against change on one card: chip_smoke.py of two (or more)
checkouts of the PyTorch/CUDA port, run in turns, with the numbers a
comparison reads pulled from their output.

    git archive HEAD | (mkdir -p build/parent && tar -x -C build/parent)
    python scripts/ab_port.py build/parent .

Runs A, B, B, A (A, B, C, C, B, A for three trees; each tree's own
chip_smoke.py, from its own root, so each builds and loads its own kernels
into its own build/kernels/), then prints every metric of each run, the
mean per tree and each tree's ratio to A, and the card's name and power
limit. The metrics: expand_pairs' (K1), composite_fwd's (K2) and
composite_bwd's (K3) ms at both views (and at tile 64, where a tree runs
it), segment_ends' (K4) and torch.searchsorted's ms, the per-Gaussian
reduction's ms (segment_sum, and the float64 cumsum path it replaced,
where a tree times them), prefix_sum_small's (K5), torch.cumsum's and
compact_runs' (K6) ms at both views, the bench view's frame median, device
time and bin stage (sparse, dense, dense with the saturation cull), and the
train step's median, device time and backward stage (sparse, dense, dense
with the cull). The full logs and a JSON summary go to --out (default
build/ab_port/). Needs one NVIDIA GPU; exits nonzero if a run does not end
with chip_smoke.py's ok line.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
NUM = r"([0-9.]+)"
# (metric, pattern): each pattern's first group is a view label where the
# metric has one, its last the number
PATTERNS = [
    ("K1 ms", rf"^  (sparse|dense) expand_pairs: {NUM} ms, plain"),
    ("K2 ms", rf"^  (sparse|dense) composite_fwd: {NUM} ms, plain"),
    ("K3 ms", rf"^  (sparse|dense) composite_bwd: {NUM} ms, plain"),
    ("K2 ms", rf"^  (sparse tile 64|dense tile 64) composite_fwd: {NUM} ms, plain"),
    ("K3 ms", rf"^  (sparse tile 64|dense tile 64) composite_bwd: {NUM} ms, plain"),
    ("K4 ms", rf"^  (sparse|dense) segment_ends: {NUM} ms, plain"),
    ("searchsorted ms", rf"^  (sparse|dense) segment_ends: .*torch\.searchsorted {NUM} ms"),
    ("reduction ms", rf"^  (sparse|dense) segment_sum: {NUM} ms, plain"),
    ("float64 cumsum path ms",
     rf"^  (sparse|dense) segment_sum: .*cumsum path it replaced {NUM} ms"),
    ("K5 ms", rf"^  (sparse|dense) prefix_sum_small: {NUM} ms, plain"),
    ("cumsum ms", rf"^  (sparse|dense) prefix_sum_small: .*torch\.cumsum {NUM} ms"),
    ("K6 ms", rf"^  (sparse|dense) compact_runs: {NUM} ms"),
    ("frame median ms", rf"^  (sparse|dense) yaw \+0: pairs .*? median {NUM}"),
    ("frame device ms", rf"^  (sparse|dense) yaw \+0: device busy \(torch\.profiler\) {NUM} ms"),
    ("frame median ms", rf"^  (dense sat): pairs .*? median {NUM}"),
    ("frame device ms", rf"^  (dense sat): device busy \(torch\.profiler\) {NUM} ms"),
    ("frame bin stage ms", rf"^  (sparse|dense) yaw \+0: pairs .*? stages .*?\bbin {NUM}"),
    ("frame bin stage ms", rf"^  (dense sat): pairs .*? stages .*?\bbin {NUM}"),
    ("step median ms", rf"^  (sparse|dense|dense sat) train step ms of \d+ synced .*?: "
                       rf"median {NUM}"),
    ("step device ms", rf"^  (sparse|dense|dense sat) train step ms of .*device busy {NUM} ms"),
    ("step backward stage ms",
     rf"^  (sparse|dense|dense sat) train step \d+ stages \(ms\): .*?\bbackward {NUM}"),
]


def parse(log: str):
    got = {}
    for line in log.splitlines():
        for metric, pat in PATTERNS:
            m = re.search(pat, line)
            if m:
                got[f"{metric} ({m.group(1)})"] = float(m.group(2))
    return got


def run(tree: Path, out: Path, tag: str, timeout: int):
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, capture_output=True,
                          text=True, timeout=timeout)
    (out / f"{tag}.log").write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    lines = proc.stdout.strip().splitlines()
    ok = proc.returncode == 0 and bool(lines) and '"ok": true' in lines[-1]
    print(f"  {tag}: {tree} rc {proc.returncode}, {time.perf_counter() - t0:.1f} s, "
          f"ok line {ok}", flush=True)
    return ok, parse(proc.stdout)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", type=Path, nargs="+",
                    help="the parent's tree first, then the change's (or changes')")
    ap.add_argument("--timeout", type=int, default=1200, help="seconds per run")
    ap.add_argument("--out", type=Path, default=REPO / "build" / "ab_port",
                    help="directory for the logs and the JSON summary")
    args = ap.parse_args()
    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    if len(args.trees) < 2:
        ap.error("give at least two trees")
    names = [chr(ord("A") + i) for i in range(len(args.trees))]
    runs = {n: [] for n in names}
    all_ok = True
    order = list(range(len(names))) + list(reversed(range(len(names))))
    for i, t in enumerate(order):
        ok, got = run(args.trees[t].resolve(), out, f"{i + 1}-{names[t]}", args.timeout)
        all_ok &= ok
        runs[names[t]].append(got)
    metrics = sorted({k for r in sum(runs.values(), []) for k in r})
    summary = {"card": card, "trees": {n: str(t) for n, t in zip(names, args.trees)},
               "metrics": {}}
    print("trees: " + ", ".join(f"{n} {t}" for n, t in zip(names, args.trees)))
    print(f"{'metric':34s} " + " ".join(f"{n + ' runs':>17s} {n + ' mean':>9s}" for n in names)
          + " " + " ".join(f"{n + ' / A':>7s}" for n in names[1:]))
    for k in metrics:
        vals = {n: [r[k] for r in runs[n] if k in r] for n in names}
        means = {n: statistics.fmean(v) if v else float("nan") for n, v in vals.items()}
        ratios = {n: means[n] / means["A"] if means["A"] else float("nan") for n in names[1:]}
        summary["metrics"][k] = {"runs": vals, "means": means, "over_a": ratios}
        print(f"{k:34s} " + " ".join(f"{' '.join(f'{v:.4f}' for v in vals[n]):>17s} "
                                     f"{means[n]:9.4f}" for n in names)
              + " " + " ".join(f"{ratios[n]:7.3f}" for n in names[1:]))
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"ab_port": "ok" if all_ok else "a run failed", "card": card}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
