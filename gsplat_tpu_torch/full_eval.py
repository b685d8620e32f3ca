"""Full-evaluation orchestrator: train -> render sets -> metrics per scene.

Port of gsplat_tpu/full_eval.py (upstream 3DGS's `full_eval.py`): for each
scene directory, `cli.main` trains into `<output_path>/<scene name>`
(`--eval --quiet` and every flag this parser does not know, forwarded
verbatim, as upstream forwards its extra arguments), `render_cli.main`
renders the train and test sets of the last iteration, and
`metrics_cli.main` scores them; every scene's results.json is gathered into
`<output_path>/full_eval.json` (the JAX module's layout). --skip_training,
--skip_rendering, --skip_metrics and --output_path keep upstream's meaning.

    python -m gsplat_tpu_torch.full_eval -o ./eval \
        --scenes /data/garden /data/bicycle --iterations 30000 [--data_device cpu]

Where the port goes past the JAX module:
- a `--data_device` among the forwarded flags goes to render_cli and
  metrics_cli too. That is the port's device rule (every entry point runs
  on the CUDA card unless the CPU is named), not a new feature: without it
  the trainer would run where it was told and the render and the metrics
  on the card.
- a `--resolution` / `-r` among them goes to render_cli too, so the sets
  are rendered and scored at the resolution the model was trained at, as
  upstream's render.py reads it back from cfg_args.
- `--lpips_vgg` / `--lpips_lin` go to metrics_cli, which fills the LPIPS
  slot with them; the JAX module has no way to pass them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Tuple


def _shared_flags(train_args: List[str]) -> Tuple[List[str], List[str]]:
    """The trainer's `--data_device` and `--resolution` / `-r` among the
    forwarded flags, parsed as the trainer's parser reads them (`-r2`,
    `--resolution=2` and prefixes too) -> (device flags, resolution flags),
    each [] when the flag is not there."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--data_device", default=None)
    p.add_argument("--resolution", "-r", default=None)
    ns, _ = p.parse_known_args(train_args)
    return ([] if ns.data_device is None else ["--data_device", ns.data_device],
            [] if ns.resolution is None else ["--resolution", ns.resolution])


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="gsplat-tpu-torch-full-eval")
    p.add_argument("--scenes", nargs="+", required=True,
                   help="COLMAP/Blender scene directories")
    p.add_argument("--output_path", "-o", default="./eval")
    p.add_argument("--skip_training", action="store_true")
    p.add_argument("--skip_rendering", action="store_true")
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--lpips_vgg", default="",
                   help="torchvision vgg16 state_dict (.pth or .npz) for metrics_cli")
    p.add_argument("--lpips_lin", default="",
                   help="lpips package vgg.pth linear heads (.pth or .npz) for metrics_cli")
    ns, train_args = p.parse_known_args(argv)
    ns.train_args = [a for a in train_args if a != "--"]
    device, resolution = _shared_flags(ns.train_args)

    out_root = Path(ns.output_path)
    out_root.mkdir(parents=True, exist_ok=True)

    model_paths = []
    for scene in ns.scenes:
        scene = Path(scene)
        model = out_root / scene.name
        model_paths.append(model)
        if not ns.skip_training:
            from gsplat_tpu_torch.cli import main as train_main

            train_main([
                "--source_path", str(scene), "--model_path", str(model),
                "--eval", "--quiet", *ns.train_args,
            ])
        if not ns.skip_rendering:
            from gsplat_tpu_torch.render_cli import main as render_main

            render_main([
                "--model_path", str(model), "--iteration", "-1",
                "--source_path", str(scene), *resolution, *device,
            ])

    if not ns.skip_metrics:
        from gsplat_tpu_torch.metrics_cli import main as metrics_main

        lp = (["--lpips_vgg", ns.lpips_vgg, "--lpips_lin", ns.lpips_lin]
              if ns.lpips_vgg or ns.lpips_lin else [])
        metrics_main(["--model_paths", *map(str, model_paths), *lp, *device])

        summary = {}
        for model in model_paths:
            rj = model / "results.json"
            if rj.exists():
                summary[model.name] = json.loads(rj.read_text())
        (out_root / "full_eval.json").write_text(json.dumps(summary, indent=1))
        print(f"wrote {out_root / 'full_eval.json'} ({len(summary)} scenes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
