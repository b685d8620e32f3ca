"""Small cells for the CPU tests: the committed cells' files, shrunk."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def tiny_cell(name: str, **config) -> harness.Cell:
    """`name`'s cell at 128x96, tile 16, chunk 32, a few thousand splats,
    six views or a 20-frame sweep."""
    cell = harness.load_cell(name)
    dense = cell.config["tile_pairs_per_gaussian"] > 10
    cfg = dict(cell.config, width=128, height=96, tile_size=16, chunk=32, scene_tile=16,
               n_gaussians=1500 if dense else 3000, capacity=4096,
               tile_pairs_per_gaussian=36.0 if dense else 4.0,
               pair_budget=(1 << 18) if dense else (1 << 16))
    cfg.update(config)
    tr = dict(cell.traffic, profile_seconds=0.2, work_sample=2, warmup_seconds=0.1)
    if tr["kind"] == "train":
        tr.update(views=6)
    else:
        tr.update(sweep_frames=20, checked_frames=3)
    return harness.Cell(name=name, config=cfg, traffic=tr, limits=cell.limits, chips=1,
                        end_to_end=cell.end_to_end, per_layer=cell.per_layer,
                        driver=cell.driver)
