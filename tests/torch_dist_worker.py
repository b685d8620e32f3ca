"""One gloo rank of the port's mesh tests on the CPU (tests/test_torch_dist.py,
tests/test_torch_multihost.py). It imports torch, numpy and the port only,
so a rank starts in seconds:

    python tests/torch_dist_worker.py steps <rank> <world> <port> <in.npz> <out_dir>
    python tests/torch_dist_worker.py cli <noise.npz | -> <multihost_smoke args...>

steps: in.npz holds a capacity-padded scene (the nine Gaussians leaves,
n_live, active_sh, max_sh), a camera batch (R, T, images; fovx, fovy), the frame
size, the mesh (data, tile), the render settings and flags; the rank joins
a tcp:// gloo group, builds the mesh and runs: the shard/gather round trip,
the replicated step, the sharded step and the eval step of camera 0 from
the same state, and writes <out_dir>/rank<r>.npz.
cli: gsplat_tpu_torch.tools.multihost_smoke with the loop's split noise
taken from noise.npz ("d<i>_<capacity>": the i-th densify's draw at that
capacity, the JAX loop's key chain), or the port's own draws with "-".
"""

import os
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

torch.set_num_threads(1)

FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "max_radii2D",
          "xyz_gradient_accum", "denom")


def _np(t):
    return t.detach().cpu().numpy()


def steps(rank, world, port, inp, out_dir):
    import torch.distributed as dist

    from gsplat_tpu_torch.config import MeshParams, OptimizationParams
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.dist import collectives as C
    from gsplat_tpu_torch.dist.data import gather_gaussians, shard_gaussians
    from gsplat_tpu_torch.dist.mesh import initialize_distributed, make_mesh
    from gsplat_tpu_torch.dist.spmd import (make_sharded_spmd_train_step, make_spmd_eval_step,
                                            make_spmd_train_step, stack_cameras)
    from gsplat_tpu_torch.interop import gaussians_from_numpy
    from gsplat_tpu_torch.train.optim import init_adam_state

    z = np.load(inp)
    W, H = int(z["W"]), int(z["H"])
    data, tile = int(z["data"]), int(z["tile"])
    if world == 1:   # the flags join no group for one process: torchrun's environment does
        os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        initialize_distributed(device="cpu")
    else:
        initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh(data, tile)
        g = gaussians_from_numpy({k: z[k] for k in FIELDS}, int(z["n_live"]),
                                 int(z["active_sh"]), int(z["max_sh"]), device="cpu")
        cams = [make_camera(z["R"][i], z["T"][i], float(z["fovx"]), float(z["fovy"]), W, H,
                            image=z["images"][i], device="cpu")
                for i in range(z["R"].shape[0])]
        mp = MeshParams(tile_size=int(z["tile_size"]), chunk_size=int(z["chunk"]),
                        pair_budget=int(z["budget"]))
        opt = OptimizationParams()
        bg = torch.zeros(3)
        res = {"d": mesh.d, "t": mesh.t,
               "tile_ranks": dist.get_process_group_ranks(mesh.tile_group),
               "data_ranks": dist.get_process_group_ranks(mesh.data_group)}
        batch = stack_cameras(cams[:data])

        def run(prefix, step_fn, g0, st0, sharded):
            grads = {}
            out = step_fn(g0, st0, batch, bg, 1, torch.zeros(()), grads_out=grads)
            g1, st1 = out[0], out[1]
            if sharded:
                g1, st1 = gather_gaussians(mesh, g1, st1)
            else:
                for k, v in grads.items():
                    res[f"{prefix}grad_{k}"] = _np(v)
            for k in FIELDS:
                res[f"{prefix}{k}"] = _np(getattr(g1, k))
            for k in st1.mu:
                res[f"{prefix}mu_{k}"] = _np(st1.mu[k])
                res[f"{prefix}nu_{k}"] = _np(st1.nu[k])
            for i, k in enumerate(("loss", "ema", "n_pairs", "n_dropped", "n_culled",
                                   "n_contrib", "n_sat")):
                res[prefix + k] = _np(out[2 + i])

        st = init_adam_state(g.params())
        run("rep_", make_spmd_train_step(mesh, opt, mp, 1.0, W, H), g, st, False)
        if g.capacity % data == 0:
            g_sh, st_sh = shard_gaussians(mesh, g, st)
            back, st_back = gather_gaussians(mesh, g_sh, st_sh)
            res["shard_rows"] = g_sh.capacity
            res["shard_round_trip"] = all(
                torch.equal(getattr(back, k), getattr(g, k)) for k in FIELDS) and all(
                torch.equal(st_back.mu[k], st.mu[k]) for k in st.mu)
            run("sha_", make_sharded_spmd_train_step(mesh, opt, mp, 1.0, W, H), g_sh, st_sh,
                True)
        if bool(z["eval"]):
            ev = make_spmd_eval_step(mesh, mp, 0.2, W, H)(g, cams[0], bg)
            for k, v in zip(("loss", "psnr", "image", "n_dropped"), ev):
                res["eval_" + k] = _np(v)
        res["comm"] = np.array(repr({k: dict(v) for k, v in C.comm.items()}))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def cli(noise, args):
    from gsplat_tpu_torch.tools import multihost_smoke
    from gsplat_tpu_torch.train import loop

    if noise != "-":
        z = np.load(noise)
        count = [0]

        def split_noise(gen, cap):
            count[0] += 1
            return torch.from_numpy(z[f"d{count[0] - 1}_{cap}"])

        loop.split_noise = split_noise
    return multihost_smoke.main(args)


if __name__ == "__main__":
    task = sys.argv[1]
    if task == "steps":
        r, w, p = (int(x) for x in sys.argv[2:5])
        steps(r, w, p, sys.argv[5], sys.argv[6])
    elif task == "cli":
        sys.exit(cli(sys.argv[2], sys.argv[3:]))
    else:
        raise SystemExit(f"unknown task {task}")
