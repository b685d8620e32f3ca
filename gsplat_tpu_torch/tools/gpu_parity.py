"""The one-command hardware check of the CUDA kernels: the render's forward
and backward through the kernels against the per-pixel oracle
(render/raster_ref.py) and autograd, on a small scene whose scales and
opacities are spread so that the clamps and the early exit all fire.

Port of scripts/tpu_parity.py, with its tolerances: the image within 2e-4
abs; each parameter group's gradient (and the screen-space offset's) within
5e-3 of that group's largest oracle gradient; the render with the kept
budget split (tight cull, post-sort stages sized by the survivors) within
3e-4 of the image and no pair dropped. It prints one JSON line with `ok`
and returns nonzero on a failure.

    python -m gsplat_tpu_torch.tools.gpu_parity [--size 128] [--n 200] [--json OUT]
        [--device cpu]

On the CPU (`--device cpu`) the render runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from gsplat_tpu_torch._device import resolve_device

IMAGE_ATOL, GRAD_RTOL, KEPT_ATOL = 2e-4, 5e-3, 3e-4


def build(n: int, size: int, device, seed: int = 0):
    """tpu_parity.py's scene: n Gaussians around the origin, scales and
    opacity logits spread by normal noise, a random target -> (g, cam)."""
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.core.gaussians import create_from_pcd

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 0.7
    cols = rng.random((n, 3))
    g = create_from_pcd(pts, cols, capacity=max(256, 1 << (n - 1).bit_length()),
                        device=device)
    d_scale = torch.from_numpy((rng.normal(size=tuple(g.scaling.shape)) * 0.5)
                               .astype(np.float32)).to(device)
    d_op = torch.from_numpy((rng.normal(size=tuple(g.opacity.shape)) * 2.0)
                            .astype(np.float32)).to(device)
    g = g.replace(scaling=g.scaling + d_scale, opacity=g.opacity + d_op)
    img = rng.random((size, size, 3)).astype(np.float32)
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), fovx=0.9, fovy=0.9,
                      width=size, height=size, image=img, device=device)
    return g, cam


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="gsplat-tpu-torch-gpu-parity")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--tile_size", type=int, default=16)
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' names the CPU")
    ns = ap.parse_args(argv)

    from gsplat_tpu_torch.render.project import project_gaussians
    from gsplat_tpu_torch.render.raster_ref import composite_reference
    from gsplat_tpu_torch.render.render import render

    device = resolve_device(ns.device)
    g, cam = build(ns.n, ns.size, device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    # the budget scales with n (~82 pairs a Gaussian covers the default
    # scene's splats): dropped pairs would truncate the image and zero the
    # gradients, a harness artefact and not a kernel difference
    budget = max(1 << 14, -(-82 * ns.n // 128) * 128)
    kw = dict(tile_size=ns.tile_size, chunk=128, pair_budget=budget)

    def grads_of(image_fn):
        params = {k: v.detach().requires_grad_() for k, v in g.params().items()}
        off = torch.zeros((g.capacity, 2), dtype=torch.float32, device=device,
                          requires_grad=True)
        with torch.enable_grad():
            img = image_fn(g.replace(**params), off)
            loss = torch.sum(img * cam.image)
            grads = torch.autograd.grad(loss, list(params.values()) + [off])
        names = list(params) + ["mean2d_offset"]
        return img.detach(), dict(zip(names, grads))

    img_k, grads_k = grads_of(lambda gg, off: render(cam, gg, bg, mean2d_offset=off,
                                                     **kw).image)
    img_o, grads_o = grads_of(lambda gg, off: composite_reference(
        project_gaussians(gg, cam, mean2d_offset=off), width=ns.size, height=ns.size,
        tile_size=ns.tile_size, bg=bg))

    report = {"device": torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu", "n": ns.n, "size": ns.size}
    ok = True
    fwd_diff = float((img_k - img_o).abs().max())
    report["fwd_max_abs_diff"] = round(fwd_diff, 8)
    ok &= fwd_diff < IMAGE_ATOL
    for name in grads_o:
        a, b = grads_k[name], grads_o[name]
        rel = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-8)
        report[f"grad_{name}_rel"] = round(rel, 8)
        ok &= bool(np.isfinite(rel)) and rel < GRAD_RTOL

    # the kept-budget split must not change the image (up to the early
    # exit's chunk boundary) and must drop nothing
    with torch.no_grad():
        out = render(cam, g, bg, kept_budget=budget - 128, **kw)
    kept_diff = float((out.image - img_k).abs().max())
    report["kept_split_max_abs_diff"] = round(kept_diff, 8)
    report["kept_split_dropped"] = int(out.n_dropped)
    ok &= kept_diff < KEPT_ATOL and int(out.n_dropped) == 0

    report["ok"] = bool(ok)
    line = json.dumps(report)
    print(line)
    if ns.json:
        Path(ns.json).write_text(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
