"""The `cli` traffic kind (drivers/cli.py) at a small size on the CPU: the
capture-train cell at 128x96, 3000 splats, six views, a 12-iteration window
with densify every 5 iterations: the program comes out correct, with its
densify and filter passes and a profiled span of iterations; the control
(no --mip_splatting) and each planted fault of faults_mip come out false."""

import contextlib
import time

import pytest
import torch

from benchmark import faults_mip, harness
from benchmark.tests.tiny import tiny_cell  # noqa: F401 (puts the repository on the path)

SEED = 2 ** 31 + 77


def small_cell() -> harness.Cell:
    cell = harness.load_cell("capture-train")
    cfg = dict(cell.config, width=128, height=96, tile_size=16, chunk=32, scene_tile=16,
               n_gaussians=3000, capacity=4096, tile_pairs_per_gaussian=4.0,
               pair_budget=1 << 16)
    tr = dict(cell.traffic, views=6, window_iterations=12, warmup_steps=1, work_sample=2,
              profile_iterations=[6004, 6008])
    i = tr["flags"].index("--densification_interval")
    tr["flags"] = tr["flags"][:i + 1] + ["5"] + tr["flags"][i + 2:]
    return harness.Cell(name=cell.name, config=cfg, traffic=tr, limits=cell.limits, chips=1,
                        end_to_end=cell.end_to_end, per_layer=cell.per_layer,
                        driver=cell.driver)


def run(traced=False, ctx=contextlib.nullcontext):
    logs = []
    with ctx():
        line = harness.run_cell(small_cell(), seed=SEED, seconds=0.1, traced=traced,
                                device=torch.device("cpu"), t_start=time.perf_counter(),
                                out=logs.append)
    return line, "\n".join(logs)


def test_program_is_correct():
    line, logs = run(traced=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 12 and line["failed"] == 0
    assert "densify passes 2, filter passes 3" in logs
    assert "step_mfu.capture" in line["metrics"]


@pytest.mark.parametrize("fault", ["control", *faults_mip.FAULTS])
def test_control_and_faults_are_caught(fault):
    ctx = faults_mip.control if fault == "control" else faults_mip.FAULTS[fault]
    line, _ = run(ctx=ctx)
    assert not line["correct"], line["checks"]
