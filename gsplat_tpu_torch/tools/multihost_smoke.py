"""One rank of a multi-process training run through the real CLI.

The counterpart of scripts/multihost_smoke.py, one process a mesh cell:
joins the process group (tcp://localhost:<port>, world <nproc>, rank
<pid>), runs gsplat_tpu_torch.cli.main with the mesh flags, then checks
that the world really was <nproc> ranks and that this rank feeds exactly
its own data row, and prints "process <pid>: rows [...] OK".

    python -m gsplat_tpu_torch.tools.multihost_smoke <pid> <nproc> <port> <scene> <out> \\
        [extra CLI flags...]

The baseline flags are the JAX script's (a 4x2 mesh: nproc 8; 4
iterations, capacity 64, pair budget 4096, chunk 32, tile 16, no densify,
no eval, --quiet); extra flags come after them (argparse: the last wins),
e.g. `--data_device cpu` for gloo ranks on the CPU, `--data_axis 2
--tile_axis 2` with nproc 4, or the sharded variant's `--shard_gaussians
--iterations 6 --densify_from_iter 1 ...`. Start every rank at once
(gsplat_tpu_torch.dist.launch.run_ranks does).
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch.distributed as dist


def cli_argv(pid: int, nproc: int, port: int, scene: str, out: str,
             extra: List[str]) -> List[str]:
    return [
        "--source_path", scene, "--model_path", out,
        "--iterations", "4", "--capacity", "64",
        "--pair_budget", "4096", "--chunk_size", "32", "--tile_size", "16",
        "--data_axis", "4", "--tile_axis", "2",
        "--num_processes", str(nproc), "--process_id", str(pid),
        "--coordinator_address", f"localhost:{port}",
        "--densify_from_iter", "100",
        "--test_iterations", "--save_iterations", "--quiet",
    ] + list(extra)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pid, nproc, port, scene, out = argv[:5]
    pid, nproc = int(pid), int(nproc)
    from gsplat_tpu_torch import cli
    from gsplat_tpu_torch.config import parse_parameters
    from gsplat_tpu_torch.dist.mesh import initialize_distributed, local_data_rows, make_mesh

    args = cli_argv(pid, nproc, int(port), scene, out, argv[5:])
    model, _, _, _, mesh = parse_parameters(args)
    initialize_distributed(mesh.coordinator_address, mesh.num_processes, mesh.process_id,
                           device=model.data_device)
    try:
        rc = cli.main(args)
        # post-conditions: the world was nproc ranks, this one rank pid, and
        # it fed exactly its own data row
        assert dist.get_world_size() == nproc, dist.get_world_size()
        assert dist.get_rank() == pid, dist.get_rank()
        dev_mesh = make_mesh(data=mesh.data_axis, tile=mesh.tile_axis)
        rows = local_data_rows(dev_mesh)
        assert rows == [pid // mesh.tile_axis], rows
        print(f"process {pid}: rows {rows} OK", flush=True)
    finally:
        dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())
