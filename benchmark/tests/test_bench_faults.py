"""`correct` against faults planted under the timed path and against the
program's lower-precision control (the packed bfloat16 pair table), at a
small size on the CPU: each comes out false; the program as it stands comes
out true. The harness's look for a card is skipped (run_cell on the CPU)."""

import time

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 31 + 4242


def run(cell, seconds=0.3):
    return harness.run_cell(cell, seed=SEED, seconds=seconds, traced=False,
                            device=torch.device("cpu"), t_start=time.perf_counter(),
                            out=lambda m: None)


@pytest.mark.parametrize("name", ["sparse-train", "sparse-view", "dense-train", "dense-view"])
def test_program_is_correct(name):
    line = run(tiny_cell(name))
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


def test_view_with_fitted_budgets_is_correct():
    """A view mix may fit kept, contrib and saturation budgets over its orbit
    (`"budgets": "fitted"`), as read-only serving does."""
    cell = tiny_cell("dense-view")
    cell.traffic.update(budgets="fitted", slack={"pair": 1.2, "kept": 1.2, "contrib": 1.5,
                                                 "sat": 1.2})
    line = run(cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("name", ["sparse-train", "sparse-view"])
def test_control_is_not_correct(name):
    with faults.control():
        line = run(tiny_cell(name))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_faults_are_caught(fault):
    with faults.TRAIN[fault]():
        line = run(tiny_cell("sparse-train"))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(faults.VIEW))
def test_view_faults_are_caught(fault):
    with faults.VIEW[fault]():
        line = run(tiny_cell("sparse-view"))
    assert not line["correct"], line["checks"]
