"""The entry refuses to run without a card, and in a directory that holds only
the benchmark's own files; on a card (marked `cuda`) one short run of each
kind prints a correct result line."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness


def run(cwd, *args, timeout=600):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = run(harness.ROOT, "--workload", "sparse-view", "--seed", str(2 ** 31 + 5),
              "--seconds", "1", "--trace", "0")
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark")
    res = run(tmp_path, "--workload", "sparse-view", "--seed", "1", "--seconds", "1",
              "--trace", "0")
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sparse-view", "sparse-train"])
def test_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    res = run(harness.ROOT, "--workload", cell, "--seed", str(2 ** 31 + 77), "--seconds", "2",
              "--trace", "1")
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["metrics"]
