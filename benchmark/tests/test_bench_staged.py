"""staged_share (metrics/staged_share.py): the rows the compositors staged
through their gids over the gid table's rows, on synthetic spans; None
where the compositors count nothing (a program whose K2 and K3 read a
gathered pair table); and read from the program's own spans in a traced
tiny run on the CPU."""

import time

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests.test_bench_spans import Event, Recorder, read, reading
from benchmark.tests.tiny import tiny_cell


def staged_steps(rec, staged_bwd=True):
    for i, (fwd, bwd) in enumerate([(10, 10), (20, 10), (30, 10)]):
        st = rec.add("step", 100 * i, 100 * i + 50)
        rec.add("gather", 100 * i, 100 * i + 1, st, rows=200, live=150)
        rec.add("composite", 100 * i + 1, 100 * i + 2, st, staged=fwd)
        if staged_bwd:
            rec.add("backward.raster", 100 * i + 3, 100 * i + 4, st, staged=bwd)


def test_staged_share_sums_k2_and_k3(monkeypatch):
    rec = Recorder()
    staged_steps(rec)
    monkeypatch.setattr(spans, "records", lambda: list(rec.recs))
    assert read("staged_share.train", reading(3)) == pytest.approx(100.0 * 90 / 600)
    assert read("staged_share.train", reading(1)) == pytest.approx(100.0 * 40 / 200)
    view = Recorder()
    staged_steps(view, staged_bwd=False)
    monkeypatch.setattr(spans, "records", lambda: list(view.recs))
    assert read("staged_share.view", reading(3)) == pytest.approx(10.0)


def test_no_staged_counter_gives_none(monkeypatch):
    rec = Recorder()
    rec.step(0, 1, 2, 1, 3, rows=10, live=5)    # a gather, no composite span
    monkeypatch.setattr(spans, "records", lambda: list(rec.recs))
    assert read("staged_share.train", reading(1)) is None
    rec.add("composite", 5, 6)                  # K2 without the counter
    assert read("staged_share.view", reading(1)) is None
    assert read("staged_share.view", reading(0)) is None
    monkeypatch.setattr(spans, "records", lambda: [])
    assert read("staged_share.train", reading(3)) is None


@pytest.mark.parametrize("name", ["sparse-view", "sparse-train"])
def test_traced_tiny_run_reads_the_staged_share(name, monkeypatch):
    monkeypatch.setattr(harness.StageRecorder, "_event",
                        staticmethod(lambda: Event(time.perf_counter() * 1e3)))
    line = harness.run_cell(tiny_cell(name), seed=2 ** 31 + 7, seconds=0.5, traced=True,
                            device=torch.device("cpu"), t_start=time.perf_counter(),
                            out=lambda m: None)
    kind = name.split("-")[1]
    share = line["metrics"][f"staged_share.{kind}"]["value"]
    assert 0 < share <= (200 if kind == "train" else 100)
