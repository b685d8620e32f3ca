"""One ZeRO-sharded mesh train step at a large capacity, with each rank's
state bytes and peak memory.

The counterpart of scripts/sharded_scale_demo.py, one process a mesh cell:
the parent starts data x tile ranks (gsplat_tpu_torch.dist.launch), each
builds only its own shard of a model whose live rows fill the capacity
(create_from_pcd's init: the 3-NN over every point, queried for the
shard's rows), runs one dist.spmd.make_sharded_spmd_train_step step over
look_at_rig cameras and prints a JSON line; the parent prints one JSON
object with every rank's: rows, the state bytes it holds sharded (the
parameters, Adam moments and densification accumulators) beside what it
would hold replicated, the step's seconds, the loss, and the peak memory
(torch.cuda.max_memory_allocated on the card, the process's peak RSS on
the CPU).

    python -m gsplat_tpu_torch.tools.sharded_scale_demo [--capacity 4194304] \\
        [--data 4 --tile 2] [--device cuda|cpu]

On one card every rank shares it (gloo, dist/mesh.py's rule).
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time

import numpy as np


def rank_main(ns) -> dict:
    import torch
    import torch.distributed as dist

    from gsplat_tpu_torch.config import MeshParams, OptimizationParams
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.core.sh import rgb2sh
    from gsplat_tpu_torch.dist.data import shard_rows
    from gsplat_tpu_torch.dist.mesh import initialize_distributed, make_mesh
    from gsplat_tpu_torch.dist.spmd import make_sharded_spmd_train_step, stack_cameras
    from gsplat_tpu_torch.interop import gaussians_from_numpy
    from gsplat_tpu_torch.io.synthetic import look_at_rig
    from gsplat_tpu_torch.train.optim import init_adam_state

    dev = initialize_distributed(f"localhost:{ns.port}", ns.data * ns.tile, ns.rank,
                                 device=ns.device)
    try:
        mesh = make_mesh(ns.data, ns.tile)
        cap = ns.capacity
        rng = np.random.default_rng(0)
        pts = (rng.normal(size=(cap, 3)) * 2.0).astype(np.float32)
        cols = rng.random((cap, 3)).astype(np.float32)
        sl = shard_rows(mesh, cap)
        from scipy.spatial import cKDTree

        dists, _ = cKDTree(pts).query(pts[sl], k=4)
        dist2 = np.maximum((dists[:, 1:] ** 2).mean(axis=1), 1e-7)
        n = sl.stop - sl.start
        rot = np.zeros((n, 4), np.float32)
        rot[:, 0] = 1.0
        zeros = np.zeros(n, np.float32)
        g = gaussians_from_numpy(dict(
            xyz=pts[sl], f_dc=rgb2sh(cols[sl]).astype(np.float32),
            f_rest=np.zeros((n, 15, 3), np.float32),
            opacity=np.full((n, 1), np.log(0.1 / 0.9), np.float32),
            scaling=np.repeat(np.log(np.sqrt(dist2))[:, None], 3, 1).astype(np.float32),
            rotation=rot, max_radii2D=zeros, xyz_gradient_accum=zeros, denom=zeros),
            n_live=cap, active_sh_degree=0, max_sh_degree=3, device=dev)
        st = init_adam_state(g.params())
        W, H = ns.width, ns.height
        cams = [make_camera(R, T, fovx=0.9, fovy=0.6, width=W, height=H,
                            image=rng.random((H, W, 3)).astype(np.float32), device=dev)
                for R, T in look_at_rig(ns.data)]
        mp = MeshParams(tile_size=16, chunk_size=32, pair_budget=1 << 15)
        step = make_sharded_spmd_train_step(mesh, OptimizationParams(), mp, 1.0, W, H)
        t0 = time.perf_counter()
        out = step(g, st, stack_cameras(cams), torch.zeros(3, device=dev), 1,
                   torch.zeros((), device=dev))
        loss = float(out[2])
        dt = time.perf_counter() - t0
        g2, st2 = out[0], out[1]
        leaves = [getattr(g2, k) for k in ("xyz", "f_dc", "f_rest", "opacity", "scaling",
                                          "rotation", "max_radii2D", "xyz_gradient_accum",
                                          "denom")] + list(st2.mu.values()) + list(
            st2.nu.values())
        state = sum(x.numel() * x.element_size() for x in leaves)
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev)
        else:
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        return {"rank": ns.rank, "d": mesh.d, "t": mesh.t, "rows": g2.capacity,
                "state_bytes_sharded": state, "state_bytes_replicated": state * ns.data,
                "step_seconds": dt, "loss": loss, "n_pairs": int(out[4]),
                "n_dropped": int(out[5]), "peak_bytes": peak,
                "finite": bool(np.isfinite(loss)) and all(
                    bool(torch.isfinite(x).all()) for x in leaves)}
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--capacity", type=int, default=1 << 22)   # 4,194,304
    ap.add_argument("--data", type=int, default=4)
    ap.add_argument("--tile", type=int, default=2)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=1800)
    ap.add_argument("--rank", type=int, default=-1)   # set by the parent for its ranks
    ap.add_argument("--port", type=int, default=0)
    ns = ap.parse_args(argv)
    if ns.rank >= 0:
        print("RANK " + json.dumps(rank_main(ns)), flush=True)
        return 0

    from gsplat_tpu_torch.dist.launch import free_port, run_ranks

    world, port = ns.data * ns.tile, free_port()
    base = [sys.executable, "-m", "gsplat_tpu_torch.tools.sharded_scale_demo",
            "--capacity", str(ns.capacity), "--data", str(ns.data), "--tile", str(ns.tile),
            "--width", str(ns.width), "--height", str(ns.height), "--device", ns.device,
            "--port", str(port)]
    env = {"OMP_NUM_THREADS": "1"} if ns.device == "cpu" else None
    res = run_ranks(lambda r: base + ["--rank", str(r)], world, ns.timeout, env=env)
    ranks = []
    for r, (rc, out) in enumerate(res):
        if rc != 0:
            print(f"rank {r} exit {rc}:\n{out[-3000:]}", file=sys.stderr)
            return 1
        ranks.append(json.loads(out[out.rindex("RANK ") + 5:].splitlines()[0]))
    ok = (all(r["finite"] and r["rows"] == ns.capacity // ns.data for r in ranks)
          and len({r["loss"] for r in ranks}) == 1)
    print(json.dumps({"capacity": ns.capacity, "mesh": {"data": ns.data, "tile": ns.tile},
                      "device": ns.device, "ranks": ranks, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
