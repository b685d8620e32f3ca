"""Read the compared numbers of a cell on many seeds, for the program, its
lower-precision control and the planted faults, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--variants program control <fault> ...] [--seconds 1] [--out <file.jsonl>]

Each (variant, seed) runs the cell as a benchmark run does (set-up, a short
window at the cell's own load, the reference) and prints one JSON line:
{"variant", "seed", "correct", "checks": {name: value}}. The limits in
checks/<cell>.json are set between the program's largest reading and the
smallest reading of the control or of a fault (PERF.md). The benchmark's own
runs never run this.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import contextlib  # noqa: E402

import torch  # noqa: E402

from benchmark import faults, harness  # noqa: E402


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["program"])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    cell = harness.load_cell(ns.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    variants = {"program": contextlib.nullcontext, "control": faults.control,
                **faults.TRAIN, **faults.VIEW}
    sink = open(ns.out, "a") if ns.out else None
    try:
        for v in ns.variants:
            for seed in ns.seeds:
                t = time.perf_counter()
                with variants[v]():
                    line = harness.run_cell(cell, seed=seed, seconds=ns.seconds, traced=False,
                                            device=torch.device("cuda"), t_start=t,
                                            out=lambda m: print(m, file=sys.stderr))
                rec = {"workload": ns.workload, "variant": v, "seed": seed,
                       "correct": line["correct"], "failed": line["failed"],
                       "checks": {k: c["value"] for k, c in line["checks"].items()},
                       "seconds": time.perf_counter() - t}
                print(json.dumps(rec), flush=True)
                if sink:
                    sink.write(json.dumps(rec) + "\n")
                    sink.flush()
                torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
