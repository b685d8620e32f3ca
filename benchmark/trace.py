"""Device time from a torch.profiler trace: busy time, idle gaps, time by kernel.

The traced run wraps part of its window in `torch.profiler.profile` (CPU and
CUDA activities) and a `bench.window` annotation, exports the Chrome trace to
a temporary file and reads it here. Device intervals are the trace's kernel,
memcpy and memset events; the busy time is the length of their union inside
the window, so overlapping streams count once. An idle gap is named by what
the host was doing at its middle: the benchmark's outermost annotation and
the innermost host event under it.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
TOP = 10


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def clip(intervals: Sequence[Tuple[float, float]], t0: float, t1: float):
    return [(max(a, t0), min(b, t1)) for a, b in intervals if b > t0 and a < t1]


def busy_share(intervals: Sequence[Tuple[float, float]], t0: float, t1: float) -> float:
    """The share of [t0, t1] that the union of the intervals covers."""
    merged = union(clip(intervals, t0, t1))
    return sum(b - a for a, b in merged) / (t1 - t0) if t1 > t0 else 0.0


def idle_gaps(intervals: Sequence[Tuple[float, float]], t0: float, t1: float):
    """The gaps of [t0, t1] that no interval covers."""
    gaps, at = [], t0
    for a, b in union(clip(intervals, t0, t1)):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < t1:
        gaps.append((at, t1))
    return gaps


class HostIndex:
    """Host events bucketed by time, to name what the host was doing at a
    time t: the outermost `bench.` annotation around t and the innermost
    host event around it."""

    BUCKET = 1000.0   # microseconds

    def __init__(self, host: Sequence[Tuple[float, float, str]]):
        self.buckets: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
        for ev in host:
            for k in range(int(ev[0] // self.BUCKET), int(ev[1] // self.BUCKET) + 1):
                self.buckets[k].append(ev)

    def label(self, t: float) -> str:
        around = [(b - a, name) for a, b, name in self.buckets.get(int(t // self.BUCKET), ())
                  if a <= t <= b]
        if not around:
            return "host: no traced event"
        outer = [x for x in around if x[1].startswith("bench.")]
        inner = min(around)[1]
        if outer:
            top = max(outer)[1]
            return top if top == inner else f"{top} / {inner}"
        return inner


def summarize(events: List[Dict]) -> Dict:
    """A Chrome trace's events -> {busy_s, window_s, kernels {name: s},
    device_ops [[name, s]], idle_gaps [[label, s]]}: times in seconds, inside
    the `bench.window` annotation (the whole trace without one)."""
    dev, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = str(e.get("cat", "")).lower()
        if cat in DEVICE_CATS:
            dev.append((a, b, str(e.get("name", ""))))
        elif cat in HOST_CATS:
            if e.get("name") == WINDOW:
                window = (a, b)
            else:
                host.append((a, b, str(e.get("name", ""))))
    if window is None:
        stamps = [x for a, b, _ in dev + host for x in (a, b)]
        window = (min(stamps), max(stamps)) if stamps else (0.0, 0.0)
    t0, t1 = window
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        if a >= t0 and b <= t1:
            by_name[name] += (b - a) * 1e-6
    ivals = [(a, b) for a, b, _ in dev]
    gaps: Dict[str, float] = defaultdict(float)
    index = HostIndex(host)
    for a, b in idle_gaps(ivals, t0, t1):
        gaps[index.label(0.5 * (a + b))] += (b - a) * 1e-6
    window_s = (t1 - t0) * 1e-6

    def top(d):
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": busy_share(ivals, t0, t1) * window_s, "window_s": window_s,
            "kernels": dict(by_name), "device_ops": top(by_name), "idle_gaps": top(gaps)}


def export_and_summarize(prof) -> Dict:
    """Export a finished profiler's Chrome trace to a temporary file (under
    TMPDIR), summarize it and delete the file."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return summarize(events)
