"""The readers of the program's spans (benchmark/spans.py and the metrics it
serves) on a recorder filled with synthetic spans: the profiled window's
spans alone, the backward split at its raster child, the gather's counters;
nothing to read (a program without spans) gives None. On the CPU a traced
tiny view run reads the gather's live share from the program's own spans."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests.tiny import tiny_cell

NEW = ("loss_bwd_ms.train", "raster_bwd_ms.train", "grad_reduce_ms.train",
       "project_bwd_ms.train", "to_bytes_ms.view", "gather_live_share.train",
       "gather_live_share.view")


class Event:
    """A CUDA event's stand-in: recorded at `t` ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


class Recorder:
    """Synthetic spans, ids in order of opening."""

    def __init__(self):
        self.recs, self.next_id = [], 1

    def add(self, name, t0, t1, parent=None, **counters):
        s = SimpleNamespace(name=name, id=self.next_id, parent=parent and parent.id,
                            ev0=Event(t0), ev1=Event(t1), counters=counters)
        self.next_id += 1
        self.recs.append(s)
        return s

    def step(self, t, before, raster, reduce, after, rows, live):
        st = self.add("step", t, t + 100)
        bwd = self.add("backward", t + 10, t + 10 + before + raster + after, st)
        r = self.add("backward.raster", t + 10 + before, t + 10 + before + raster, bwd)
        self.add("backward.raster.reduce", t + 11 + before, t + 11 + before + reduce, r)
        self.add("gather", t, t + 1, st, rows=rows, live=live)
        self.add("gui.to_bytes", t + 50, t + 50 + after)


def reading(units):
    return harness.Reading(stages={}, trace=None, traced_units=units, unit_seconds=None,
                           work=None, pixels=1, live=1, params_per_splat=59)


def read(name, run):
    return harness.load_reader(name)(run)


def test_readers_take_the_window_and_split_the_backward(monkeypatch):
    rec = Recorder()
    for i in range(3):           # warm-up steps under the profiler, before the window
        rec.step(1000 * i, before=50, raster=50, reduce=40, after=50, rows=10, live=1)
    for i, (before, raster, after) in enumerate([(2, 10, 20), (4, 12, 30), (3, 11, 25)]):
        rec.step(5000 + 1000 * i, before, raster, reduce=5 + i, after=after, rows=100,
                 live=80 - 10 * i)
    monkeypatch.setattr(spans, "records", lambda: list(rec.recs))
    run = reading(3)
    assert read("loss_bwd_ms.train", run) == 3
    assert read("raster_bwd_ms.train", run) == 11
    assert read("grad_reduce_ms.train", run) == 6
    assert read("project_bwd_ms.train", run) == 25
    assert read("to_bytes_ms.view", run) == 25
    assert read("gather_live_share.train", run) == read("gather_live_share.view", run) == 70.0
    # the parts tile the backward
    b = spans.window(run, "backward")
    assert [x.ev0.elapsed_time(x.ev1) for x in b] == [32, 46, 39]


def test_nothing_to_read_gives_none(monkeypatch):
    run = reading(4)
    monkeypatch.setattr(spans, "records", lambda: [])
    assert all(read(n, run) is None for n in NEW)
    rec = Recorder()
    rec.step(0, 1, 2, 1, 3, rows=10, live=5)
    monkeypatch.setattr(spans, "records", lambda: list(rec.recs))
    assert all(read(n, reading(0)) is None for n in NEW)
    rec.recs[-2].counters.clear()         # a gather span without counters
    assert read("gather_live_share.view", reading(1)) is None


def test_a_program_without_spans(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "gsplat_tpu_torch.spans", None)   # import fails
    assert spans.records() == []
    assert all(read(n, reading(3)) is None for n in NEW)


@pytest.mark.parametrize("name", ["sparse-view", "sparse-train"])
def test_traced_tiny_run_reads_the_program(name, monkeypatch):
    """On the CPU the spans carry no device times: the live share alone (the
    stage recorder's CUDA events become host-clock stand-ins)."""
    monkeypatch.setattr(harness.StageRecorder, "_event",
                        staticmethod(lambda: Event(time.perf_counter() * 1e3)))
    line = harness.run_cell(tiny_cell(name), seed=2 ** 31 + 99, seconds=0.5, traced=True,
                            device=torch.device("cpu"), t_start=time.perf_counter(),
                            out=lambda m: None)
    kind = name.split("-")[1]
    share = line["metrics"][f"gather_live_share.{kind}"]["value"]
    assert 0 < share <= 100
    assert not {n for n in NEW if "_ms." in n} & set(line["metrics"])
