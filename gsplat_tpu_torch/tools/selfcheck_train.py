"""Training self-check on the card: synthesize a scene whose ground-truth
images come from the renderer itself, train from a perturbed start, and
check that PSNR climbs. It runs the whole training path (render -> loss ->
the backward kernels -> Adam -> densify -> eval) on the device.

Port of scripts/selfcheck_train.py. It prints PASS when the final mean PSNR
over every fourth camera reaches --min_psnr (22), else FAIL, and returns 0
or 1.

    python -m gsplat_tpu_torch.tools.selfcheck_train [--iters 600] [--size 256]
        [--n_gt 2000] [--device cpu]

The split noise of densify draws from a torch.Generator seeded 0 on the
device (the JAX script: jax.random.PRNGKey(0)).
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.core.gaussians import Gaussians, create_from_pcd


def _solid(g: Gaussians, opacity: float, scale: float) -> Gaussians:
    """The live rows at one opacity logit and one isotropic scale."""
    live = g.live_mask[:, None]
    return g.replace(
        opacity=torch.where(live, torch.full_like(g.opacity, opacity), g.opacity),
        scaling=torch.where(live, torch.full_like(g.scaling, math.log(scale)), g.scaling))


def gt_scene(n: int, seed: int = 0, device: Optional[Union[str, torch.device]] = None):
    """Ground-truth Gaussians: colourful blobs on a sphere shell and a core
    cluster -> (Gaussians, points, colours)."""
    rng = np.random.default_rng(seed)
    shell = rng.normal(size=(n // 2, 3))
    shell /= np.linalg.norm(shell, axis=1, keepdims=True)
    core = rng.normal(size=(n - n // 2, 3)) * 0.3
    pts = np.concatenate([shell, core])
    colors = np.concatenate([
        (pts[: n // 2] + 1) / 2,                     # position-coded colours
        rng.random((n - n // 2, 3)),
    ])
    cap = 1 << max(13, int(np.ceil(np.log2(n + 1))))
    g = create_from_pcd(pts, colors, capacity=cap, device=device)
    return _solid(g, 2.0, 0.06), pts, colors


def textured_scene(n: int, seed: int = 0, device: Optional[Union[str, torch.device]] = None):
    """Harder ground truth for the quality proxy: many small solid Gaussians
    on surfaces (a ground plane, a sphere shell and a torus) with
    high-frequency procedural colours -> (Gaussians, points, colours)."""
    rng = np.random.default_rng(seed)
    n_pl, n_sh = n // 3, n // 3
    n_to = n - n_pl - n_sh
    # ground plane y=-1.05, extent 2.4
    pl = np.stack([
        rng.uniform(-1.2, 1.2, n_pl),
        np.full(n_pl, -1.05) + rng.normal(0, 0.003, n_pl),
        rng.uniform(-1.2, 1.2, n_pl),
    ], 1)
    sh = rng.normal(size=(n_sh, 3))
    sh /= np.linalg.norm(sh, axis=1, keepdims=True)
    sh *= 0.75
    phi = rng.uniform(0, 2 * np.pi, n_to)
    theta = rng.uniform(0, 2 * np.pi, n_to)
    to = np.stack([
        (1.0 + 0.28 * np.cos(theta)) * np.cos(phi),
        0.28 * np.sin(theta) - 0.3,
        (1.0 + 0.28 * np.cos(theta)) * np.sin(phi),
    ], 1)
    pts = np.concatenate([pl, sh, to])
    # high-frequency colour: trig interference and a checker on the plane
    f = 9.0
    base = 0.5 + 0.5 * np.stack([
        np.sin(f * pts[:, 0]) * np.sin(f * 1.3 * pts[:, 2]),
        np.sin(f * 0.8 * pts[:, 1] + 2.1) * np.cos(f * pts[:, 0]),
        np.cos(f * 1.7 * pts[:, 2] + 0.7),
    ], 1)
    checker = ((np.floor(pts[:, 0] * 4) + np.floor(pts[:, 2] * 4)) % 2)[:, None]
    colors = np.clip(0.75 * base + 0.25 * checker, 0, 1)
    cap = 1 << int(np.ceil(np.log2(n + 1)))
    g = create_from_pcd(pts, colors, capacity=cap, device=device)
    return _solid(g, 2.5, 0.012), pts, colors


def rig(n_cams: int, radius: float = 3.5):
    """Cameras on a wavy circle looking at the origin -> [(R cam-to-world,
    T world-to-cam)]."""
    out = []
    for i in range(n_cams):
        ang = 2 * math.pi * i / n_cams
        el = 0.35 * math.sin(3 * ang)
        pos = np.array([
            radius * math.cos(el) * math.sin(ang),
            radius * math.sin(el),
            radius * math.cos(el) * math.cos(ang),
        ])
        fwd = -pos / np.linalg.norm(pos)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        R_w2c = np.stack([right, np.cross(fwd, right), fwd])
        out.append((R_w2c.T, -R_w2c @ pos))
    return out


def run(argv: Optional[List[str]] = None) -> Tuple[int, Dict[str, Any]]:
    """The self-check (see the module doc) -> (0 on PASS else 1, the final
    state: `g`, the `cams`, `bg` and the `mesh` the run rendered with)."""
    ap = argparse.ArgumentParser(prog="gsplat-tpu-torch-selfcheck")
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--n_gt", type=int, default=2000)
    ap.add_argument("--n_cams", type=int, default=24)
    ap.add_argument("--pair_budget", type=int, default=1 << 18)
    ap.add_argument("--min_psnr", type=float, default=22.0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' names the CPU")
    ns = ap.parse_args(argv)

    from gsplat_tpu_torch.config import MeshParams, OptimizationParams
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.densify import densify_and_prune, split_noise
    from gsplat_tpu_torch.train.loop import make_train_step
    from gsplat_tpu_torch.train.loss import psnr
    from gsplat_tpu_torch.train.optim import init_adam_state

    device = resolve_device(ns.device)
    S = ns.size
    g_true, pts, colors = gt_scene(ns.n_gt, device=device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)

    def image(cam, g):
        with torch.no_grad():
            return render(cam, g, bg, tile_size=16, chunk=128,
                          pair_budget=ns.pair_budget).image

    print("rendering ground truth...", flush=True)
    cams = []
    for R, T in rig(ns.n_cams):
        cam = make_camera(R, T, fovx=0.9, fovy=0.9, width=S, height=S, device=device)
        cams.append(make_camera(R, T, fovx=0.9, fovy=0.9, width=S, height=S,
                                image=image(cam, g_true).cpu().numpy(), device=device))

    # perturbed start: noisy positions, random colours, default opacity/scale
    rng = np.random.default_rng(1)
    g = create_from_pcd(pts + rng.normal(size=pts.shape) * 0.05, rng.random(colors.shape),
                        capacity=1 << 13, spatial_lr_scale=3.5, device=device)
    opt_state = init_adam_state(g.params())
    opt = OptimizationParams(
        iterations=ns.iters,
        densify_from_iter=100,
        densification_interval=150,
        densify_until_iter=ns.iters // 2,
        opacity_reset_interval=10 ** 9,  # no resets in this short run
    )
    mesh = MeshParams(tile_size=16, chunk_size=128, pair_budget=ns.pair_budget)
    step_fn = make_train_step(opt, mesh, g.spatial_lr_scale, S, S)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def mean_psnr() -> float:
        return float(np.mean([float(psnr(image(c, g), c.image)) for c in cams[::4]]))

    print(f"initial PSNR {mean_psnr():.2f}", flush=True)
    t0 = time.time()
    ema = torch.zeros((), dtype=torch.float32, device=device)
    for it in range(1, ns.iters + 1):
        if it % 1000 == 0:
            g = g.oneup_sh_degree()
        cam = cams[(it * 7) % len(cams)]
        g, opt_state, loss, ema, n_pairs, n_dropped, _, _, _ = step_fn(
            g, opt_state, cam, bg, it, ema)
        if (opt.densify_from_iter < it < opt.densify_until_iter
                and it % opt.densification_interval == 0):
            g, opt_state, _ = densify_and_prune(
                g, opt_state, split_noise(gen, g.capacity),
                max_grad=opt.densify_grad_threshold, min_opacity=0.005, extent=3.5,
                max_screen_size=0.0, percent_dense=opt.percent_dense)
        if it % 100 == 0:
            print(f"iter {it} loss {float(loss):.4f} gaussians {int(g.n_live)} "
                  f"({100 / (time.time() - t0):.1f} it/s)", flush=True)
            t0 = time.time()

    final = mean_psnr()
    print(f"final PSNR {final:.2f} (threshold {ns.min_psnr})", flush=True)
    state = dict(g=g, cams=cams, bg=bg, mesh=mesh)
    if not final >= ns.min_psnr:
        print("FAIL: training did not converge", flush=True)
        return 1, state
    print("PASS", flush=True)
    return 0, state


def main(argv: Optional[List[str]] = None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
