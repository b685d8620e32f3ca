"""Training CLI: the port's counterpart of gsplat_tpu/cli.py (upstream 3DGS's
`train.py`; reference src/train.cpp:12-47). Run as:

    python -m gsplat_tpu_torch.cli -s <scene> -m <out> [--eval ...]

It parses the flags, joins the process group of a multi-process mesh
before any device use (with --num_processes > 1: --coordinator_address
host:port and --process_id; or torchrun's environment), prints the five
parameter groups (rank 0 only), appends the final iteration to
save_iterations, seeds Python's and numpy's generators, turns on autograd's
anomaly mode behind --detect_anomaly or --debug (the JAX package:
jax_debug_nans), calls train() and prints "Training complete.". Training
runs on --data_device (default cuda; a CUDA rank takes the card of its
local rank, dist/mesh.py). The JAX package's compile-cache and platform
settings have no counterpart here. A mesh on the CPU, four gloo ranks of a
2x2 mesh:

    torchrun --nproc_per_node 4 -m gsplat_tpu_torch.cli -s <scene> -m <out> \
        --data_device cpu --data_axis 2 --tile_axis 2
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch
import torch.distributed as dist

from gsplat_tpu_torch.config import parse_parameters, print_params
from gsplat_tpu_torch.dist.mesh import initialize_distributed, torchrun_env
from gsplat_tpu_torch.train.loop import initialize_random_seed, train


def main(argv: Optional[List[str]] = None) -> int:
    model, opt, pipe, other, mesh = parse_parameters(argv)

    # the multi-process bootstrap precedes any device use (a caller that
    # joined the group already keeps it)
    joined = False
    if (mesh.num_processes > 1 or torchrun_env()) and not dist.is_initialized():
        initialize_distributed(
            coordinator_address=mesh.coordinator_address or None,
            num_processes=mesh.num_processes or None,
            process_id=mesh.process_id if mesh.process_id >= 0 else None,
            device=model.data_device)
        joined = dist.is_initialized()
    try:
        return _run(model, opt, pipe, other, mesh)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(model, opt, pipe, other, mesh) -> int:
    if not dist.is_initialized() or dist.get_rank() == 0:
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
