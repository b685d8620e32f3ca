"""Write a self-consistent synthetic COLMAP dataset: the ground-truth images
are rendered by the port itself from a procedural Gaussian scene, so a full
training run can be checked end to end without outside datasets.

Port of scripts/make_synthetic_scene.py: the same scenes (selfcheck_train's
`gt_scene`, or `textured_scene` with --textured), camera rig, PINHOLE
intrinsics and noisy points3D, the images rendered at tile 16, chunk 128,
rounded to 8 bits and written through io/png.py.

    python -m gsplat_tpu_torch.tools.make_synthetic_scene /tmp/synth --n_cams 32 --size 256
        [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from gsplat_tpu_torch._device import resolve_device


def write_scene(out: Union[str, Path], *, n_cams: int = 32, width: int = 256,
                height: int = 256, n_gt: int = 2000, textured: bool = False,
                pair_budget: int = 1 << 18, noise: float = 0.03,
                device: Optional[Union[str, torch.device]] = None) -> dict:
    """The scene under `out` (images/, sparse/0/) -> seconds of its parts:
    {"render", "encode", "total"}."""
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.io import colmap, png
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.tools.selfcheck_train import gt_scene, rig, textured_scene

    t_all = time.perf_counter()
    device = resolve_device(device)
    g_true, pts, colors = (textured_scene if textured else gt_scene)(n_gt, device=device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    sparse, img_dir = Path(out) / "sparse" / "0", Path(out) / "images"
    sparse.mkdir(parents=True, exist_ok=True)
    img_dir.mkdir(parents=True, exist_ok=True)

    fovx = 0.9
    focal = 0.5 * width / math.tan(fovx / 2)
    fovy = 2 * math.atan(0.5 * height / focal)
    colmap.write_intrinsics_binary({1: colmap.Camera(
        id=1, model="PINHOLE", width=width, height=height,
        params=np.array([focal, focal, width / 2, height / 2]))}, sparse / "cameras.bin")

    imgs, t_render, t_encode = {}, 0.0, 0.0
    for i, (R, T) in enumerate(rig(n_cams), start=1):
        cam = make_camera(R, T, fovx=fovx, fovy=fovy, width=width, height=height,
                          device=device)
        t0 = time.perf_counter()
        with torch.no_grad():
            img = render(cam, g_true, bg, tile_size=16, chunk=128,
                         pair_budget=pair_budget).image
        arr = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
        t_render += time.perf_counter() - t0
        name = f"img_{i:03d}.png"
        t0 = time.perf_counter()
        png.write_png(img_dir / name, arr)
        t_encode += time.perf_counter() - t0
        imgs[i] = colmap.Image(id=i, qvec=colmap.rotmat2qvec(R.T), tvec=T, camera_id=1,
                               name=name)
    colmap.write_extrinsics_binary(imgs, sparse / "images.bin")

    noisy = pts + np.random.default_rng(7).normal(size=pts.shape) * noise
    rgb8 = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    colmap.write_points3D_binary(noisy, rgb8, np.zeros(len(pts)), sparse / "points3D.bin")
    return dict(render=t_render, encode=t_encode, total=time.perf_counter() - t_all)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="gsplat-tpu-torch-make-synthetic-scene")
    ap.add_argument("out", type=Path)
    ap.add_argument("--n_cams", type=int, default=32)
    ap.add_argument("--size", type=int, default=256,
                    help="square size; or use --width/--height")
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--n_gt", type=int, default=2000)
    ap.add_argument("--textured", action="store_true",
                    help="high-frequency textured ground truth (quality-proxy runs)")
    ap.add_argument("--pair_budget", type=int, default=1 << 18)
    ap.add_argument("--noise", type=float, default=0.03,
                    help="std of the noise added to the points written as points3D")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' names the CPU")
    ns = ap.parse_args(argv)
    part = write_scene(ns.out, n_cams=ns.n_cams, width=ns.width or ns.size,
                       height=ns.height or ns.size, n_gt=ns.n_gt, textured=ns.textured,
                       pair_budget=ns.pair_budget, noise=ns.noise, device=ns.device)
    print(f"wrote scene to {ns.out}: {ns.n_cams} images in {part['total']:.1f} s "
          f"(renders {part['render']:.1f} s, PNG encodes {part['encode']:.1f} s)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
