"""Run one cell of BENCHMARK.json on the CUDA card(s) and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, with --trace 1 the
breakdown, and last the compared numbers beside their limits, which are also
the last lines of standard error). Without enough CUDA devices it exits 2 and
prints no result; if the run loaded JAX or the JAX package, it exits 3.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
