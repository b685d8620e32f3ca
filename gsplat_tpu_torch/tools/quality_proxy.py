"""Quality proxy: the upstream training schedule on a hard textured
synthetic scene (make_synthetic_scene --textured), recording the test PSNR
and the Gaussian count as it trains.

Port of scripts/quality_proxy.py. `make_scene` builds the scene at the
script's defaults (120 cameras, 960x540, 60,000 ground-truth Gaussians,
pair budget 2^21); `main` builds it, trains with the port's CLI and writes
<root>/quality_proxy.json.

    python -m gsplat_tpu_torch.tools.quality_proxy /tmp/qproxy [--iters 30000]
        [--width 960 --height 540] [--n_cams 120] [--n_gt 60000] [--data_device cpu]

The repo's record of the JAX trainer's 1000-iteration run is
artifacts/qproxy_sat30/; chip_smoke.py holds the port to it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Union

import torch

WIDTH, HEIGHT, N_CAMS, N_GT, CAPACITY, PAIR_BUDGET = 960, 540, 120, 60_000, 1 << 17, 1 << 21


def make_scene(scene_dir: Union[str, Path], *, width: int = WIDTH, height: int = HEIGHT,
               n_cams: int = N_CAMS, n_gt: int = N_GT, pair_budget: int = PAIR_BUDGET,
               device: Optional[Union[str, torch.device]] = None) -> dict:
    """The textured scene under `scene_dir` -> seconds of its parts
    (make_synthetic_scene.write_scene)."""
    from gsplat_tpu_torch.tools.make_synthetic_scene import write_scene

    return write_scene(scene_dir, n_cams=n_cams, width=width, height=height, n_gt=n_gt,
                       textured=True, pair_budget=pair_budget, device=device)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="gsplat-tpu-torch-quality-proxy")
    ap.add_argument("root", type=Path)
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    # 120 cameras: at 48 the scene's sparse view coverage, not the trainer,
    # sets the train/test gap (19 dB); at 120 it closes to ~1.7 dB
    ap.add_argument("--n_cams", type=int, default=N_CAMS)
    ap.add_argument("--n_gt", type=int, default=N_GT)
    ap.add_argument("--capacity", type=int, default=CAPACITY)
    ap.add_argument("--pair_budget", type=int, default=PAIR_BUDGET)
    ap.add_argument("--skip_make", action="store_true")
    ap.add_argument("--start_checkpoint", default="")
    ap.add_argument("--data_device", default=None,
                    help="default: the CUDA card; 'cpu' names the CPU")
    ns = ap.parse_args(argv)

    scene_dir, out_dir = ns.root / "scene", ns.root / "out"
    if not ns.skip_make:
        make_scene(scene_dir, width=ns.width, height=ns.height, n_cams=ns.n_cams,
                   n_gt=ns.n_gt, pair_budget=ns.pair_budget, device=ns.data_device)

    from gsplat_tpu_torch.cli import main as cli_main

    argv_train = [
        "--source_path", str(scene_dir), "--model_path", str(out_dir),
        "--eval", "--iterations", str(ns.iters),
        "--capacity", str(ns.capacity), "--pair_budget", str(ns.pair_budget),
        "--tile_size", "16",
        "--test_iterations", "1000", "7000", "15000", str(ns.iters),
        "--save_iterations", "7000", str(ns.iters),
        "--checkpoint_iterations", "7000", "15000", "22000", str(ns.iters),
    ]
    if ns.start_checkpoint:
        argv_train += ["--start_checkpoint", ns.start_checkpoint]
    if ns.data_device:
        argv_train += ["--data_device", ns.data_device]
    cli_main(argv_train)

    # summarize the metrics stream
    lines = [json.loads(ln) for ln in (out_dir / "metrics.jsonl").read_text().splitlines()]
    evals = [ln for ln in lines if "test_psnr" in ln]
    growth = [(ln["step"], ln["n_gaussians"]) for ln in lines if "n_gaussians" in ln]
    summary = {
        "config": {
            "iters": ns.iters, "resolution": f"{ns.width}x{ns.height}",
            "n_cams": ns.n_cams, "n_gt": ns.n_gt,
        },
        "test_psnr_by_iter": {str(ln["step"]): ln["test_psnr"] for ln in evals},
        "final_test_psnr": evals[-1]["test_psnr"] if evals else None,
        "gaussian_count_trajectory": growth[:: max(len(growth) // 20, 1)],
    }
    (ns.root / "quality_proxy.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary["test_psnr_by_iter"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
