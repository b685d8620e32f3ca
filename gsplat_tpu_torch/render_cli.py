"""Render-sets CLI: render every train/test camera of a trained model to PNG.

Port of gsplat_tpu/render_cli.py (upstream 3DGS's `render.py`). Usage:

    python -m gsplat_tpu_torch.render_cli --model_path <out> [--iteration -1]
        [--skip_train] [--skip_test] [--data_device cuda]

Writes <model>/{train,test}/ours_<iter>/{renders,gt}/NNNNN.png, the PNGs
through the port's own codec (io/png.py). The flags are the JAX CLI's, plus
upstream's `--data_device` (default cuda: the device the scene, and so the
render, runs on).
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from gsplat_tpu_torch.config import MeshParams, ModelParams
from gsplat_tpu_torch.io import png
from gsplat_tpu_torch.render.render import render
from gsplat_tpu_torch.scene import Scene


def save_png(path: Path, img: np.ndarray) -> None:
    """A float image in [0, 1] -> an 8-bit RGB PNG (rounded to nearest)."""
    arr = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    png.write_png(path, arr)


def render_set(model_path: Path, name: str, iteration: int, cams, g, bg: torch.Tensor,
               mesh: MeshParams) -> None:
    base = model_path / name / f"ours_{iteration}"
    budget = mesh.pair_budget
    idx = 0
    while idx < len(cams):
        cam = cams[idx]
        out = render(cam, g, bg, tile_size=mesh.tile_size, chunk=mesh.chunk_size,
                     pair_budget=budget)
        if int(out.n_dropped) > 0:
            # dropped pairs = silently wrong render; grow and redo this camera
            budget *= 2
            print(f"[{name}] {int(out.n_dropped)} pairs dropped; "
                  f"pair budget -> {budget}", flush=True)
            continue
        save_png(base / "renders" / f"{idx:05d}.png", out.image.cpu().numpy())
        if cam.image is not None:
            save_png(base / "gt" / f"{idx:05d}.png", cam.image.cpu().numpy())
        idx += 1
        print(f"[{name}] rendered {idx}/{len(cams)}", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="gsplat-tpu-torch-render")
    p.add_argument("--model_path", required=True)
    p.add_argument("--source_path", default="")
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--resolution", type=int, default=-1)
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--eval", action="store_true", default=True)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--pair_budget", type=int, default=1 << 20)
    p.add_argument("--tile_size", type=int, default=32)
    p.add_argument("--chunk_size", type=int, default=128)
    p.add_argument("--data_device", default="cuda",
                   help="device of the scene and the render (upstream's flag)")
    ns = p.parse_args(argv)

    source = ns.source_path
    if not source:
        # recover from cfg_args (written at train time, upstream-compatible)
        cfg = (Path(ns.model_path) / "cfg_args").read_text()
        m = re.search(r"source_path='([^']*)'", cfg)
        if not m:
            raise SystemExit("--source_path not given and not found in cfg_args")
        source = m.group(1)

    model = ModelParams(
        sh_degree=ns.sh_degree, source_path=source, model_path=ns.model_path,
        resolution=ns.resolution, white_background=ns.white_background, eval=ns.eval,
        data_device=ns.data_device,
    )
    mesh = MeshParams(pair_budget=ns.pair_budget, tile_size=ns.tile_size,
                      chunk_size=ns.chunk_size)
    scene = Scene(model, load_iteration=ns.iteration, shuffle=False)
    g = scene.gaussians
    bg = torch.tensor([1.0, 1.0, 1.0] if ns.white_background else [0.0, 0.0, 0.0],
                      dtype=torch.float32, device=g.device)

    with torch.no_grad():
        if not ns.skip_train:
            render_set(Path(ns.model_path), "train", scene.loaded_iter,
                       scene.get_train_cameras(), g, bg, mesh)
        if not ns.skip_test:
            render_set(Path(ns.model_path), "test", scene.loaded_iter,
                       scene.get_test_cameras(), g, bg, mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
