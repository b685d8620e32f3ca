"""Training CLI: the port's counterpart of gsplat_tpu/cli.py (upstream 3DGS's
`train.py`; reference src/train.cpp:12-47). Run as:

    python -m gsplat_tpu_torch.cli -s <scene> -m <out> [--eval ...]

It parses the flags, prints the five parameter groups, appends the final
iteration to save_iterations, seeds Python's and numpy's generators, turns
on autograd's anomaly mode behind --detect_anomaly or --debug (the JAX
package: jax_debug_nans), calls train() and prints "Training complete.".
Training runs on --data_device (default cuda). The JAX package's
compile-cache and platform settings have no counterpart here.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from gsplat_tpu_torch.config import parse_parameters, print_params
from gsplat_tpu_torch.train.loop import initialize_random_seed, train


def main(argv: Optional[List[str]] = None) -> int:
    model, opt, pipe, other, mesh = parse_parameters(argv)
    for p in (model, opt, pipe, other, mesh):
        print_params(p, out=sys.stdout)

    # reference src/train.cpp:30: always save the final iteration
    if opt.iterations not in other.save_iterations:
        other.save_iterations.append(opt.iterations)

    initialize_random_seed(0)

    # reference src/train.cpp:39: autograd anomaly detection
    if other.detect_anomaly or pipe.debug:
        torch.autograd.set_detect_anomaly(True)

    train(model, opt, pipe, other, mesh)
    print("Training complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
