"""Metrics CLI: PSNR / SSIM / L1 / LPIPS over rendered sets.

Port of gsplat_tpu/metrics_cli.py (upstream 3DGS's `metrics.py`). For each
model, every `<model>/{test,train}/<method>/{renders,gt}` pair of PNG
directories is scored image by image (SSIM, PSNR and L1 from train/loss.py;
LPIPS from lpips.py when both weight files are given, else null) and the
means are written to `<model>/results.json`, with the JAX module's keys and
printed lines.

    python -m gsplat_tpu_torch.metrics_cli --model_paths <out> [<out2> ...] \
        [--lpips_vgg vgg16-397923af.pth --lpips_lin vgg.pth] [--data_device cpu]

The PNGs decode through io/png.py (no PIL) to float32 / 255, as the JAX
module's PIL path gives them. The metrics run on --data_device: the CUDA
card unless the CPU is named. SSIM, PSNR and L1 are computed in float64
from the 8-bit images (LPIPS in float32): SSIM's variances are blurs of x^2
less squared blurs of x, which cancel, and on a noisy render its map
averages to ~0.01 from terms near +-1, so that a float32 SSIM moves in the
fifth digit between the card's convolutions and the CPU's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.io.png import read_png
from gsplat_tpu_torch.lpips import load_lpips_weights, lpips, lpips_to_device
from gsplat_tpu_torch.train.loss import l1_loss, psnr, ssim


def _load_dir(d: Path) -> List[np.ndarray]:
    return [read_png(p).astype(np.float32) / 255.0 for p in sorted(d.iterdir())]


def evaluate_model(model_path: Path, lpips_params: Optional[dict] = None,
                   device: Optional[Union[str, torch.device]] = None) -> dict:
    """{"<split>/<method>": {"SSIM", "PSNR", "L1", "LPIPS", "n_images"}} of
    one model directory, computed on `device` (CUDA unless named)."""
    device = resolve_device(device)
    if lpips_params is not None:
        lpips_params = lpips_to_device(lpips_params, device)

    results = {}
    for split in ("test", "train"):
        split_dir = Path(model_path) / split
        if not split_dir.exists():
            continue
        for method_dir in sorted(split_dir.iterdir()):
            renders_dir = method_dir / "renders"
            gt_dir = method_dir / "gt"
            if not renders_dir.exists() or not gt_dir.exists():
                continue
            renders = _load_dir(renders_dir)
            gts = _load_dir(gt_dir)
            ssims, psnrs, l1s, lps = [], [], [], []
            with torch.no_grad():
                for r, gt in zip(renders, gts):
                    r_t = torch.from_numpy(r).to(device)
                    gt_t = torch.from_numpy(gt).to(device)
                    r64, gt64 = r_t.double(), gt_t.double()
                    ssims.append(float(ssim(r64, gt64)))
                    psnrs.append(float(psnr(r64, gt64)))
                    l1s.append(float(l1_loss(r64, gt64)))
                    if lpips_params is not None:
                        lps.append(float(lpips(lpips_params, r_t, gt_t)))
            results[f"{split}/{method_dir.name}"] = {
                "SSIM": float(np.mean(ssims)) if ssims else None,
                "PSNR": float(np.mean(psnrs)) if psnrs else None,
                "L1": float(np.mean(l1s)) if l1s else None,
                # null unless the user supplied pretrained weights (see module doc)
                "LPIPS": float(np.mean(lps)) if lps else None,
                "n_images": len(renders),
            }
    return results


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="gsplat-tpu-torch-metrics")
    p.add_argument("--model_paths", "-m", nargs="+", required=True)
    p.add_argument("--lpips_vgg", default="",
                   help="torchvision vgg16 state_dict (.pth or .npz)")
    p.add_argument("--lpips_lin", default="",
                   help="lpips package vgg.pth linear heads (.pth or .npz)")
    p.add_argument("--data_device", default=None,
                   help="device of the metrics (default: the CUDA card; 'cpu' names the CPU)")
    ns = p.parse_args(argv)

    lpips_params = None
    if bool(ns.lpips_vgg) != bool(ns.lpips_lin):
        p.error("--lpips_vgg and --lpips_lin must be given together")
    if ns.lpips_vgg:
        lpips_params = load_lpips_weights(ns.lpips_vgg, ns.lpips_lin)

    for mp in ns.model_paths:
        mp = Path(mp)
        results = evaluate_model(mp, lpips_params, ns.data_device)
        print(f"\nScene: {mp}")
        for method, vals in results.items():
            lp = f"  LPIPS {vals['LPIPS']:.4f}" if vals["LPIPS"] is not None else ""
            print(f"  {method}: PSNR {vals['PSNR']:.4f}  SSIM {vals['SSIM']:.4f}  "
                  f"L1 {vals['L1']:.5f}{lp}  ({vals['n_images']} images)")
        with open(mp / "results.json", "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
