"""The program's spans as the per-layer readers read them.

The program records its spans (`gsplat_tpu_torch.spans`) only while a
torch.profiler session runs, that is in a traced run's set-up and the
window's profiled part; recording stops with the profiler, so the last
`run.traced_units` spans of a name that occurs once a step or frame are
the profiled window's. A program without spans, or a run without them,
gives the readers nothing to read: they return None and raise nothing.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def records() -> List:
    """The program's finished spans, oldest first; [] where it has none."""
    try:
        from gsplat_tpu_torch import spans
    except ImportError:
        return []
    return spans.records()


def window(run, name: str, recs: Optional[List] = None) -> List:
    """The profiled window's spans named `name`: the last run.traced_units
    of them."""
    if not run.traced_units:
        return []
    got = [r for r in (records() if recs is None else recs) if r.name == name]
    return got[-run.traced_units:]


def elapsed_ms(a, b) -> Optional[float]:
    """Device ms from CUDA event a to event b (recorded, synchronised), or None."""
    if a is None or b is None:
        return None
    try:
        return a.elapsed_time(b)
    except RuntimeError:
        return None


def children(recs: List, name: str) -> Dict[int, object]:
    """{parent id: its child named `name`} over the records."""
    return {r.parent: r for r in recs if r.name == name and r.parent is not None}


def median(values) -> Optional[float]:
    vals = [v for v in values if v is not None]
    return statistics.median(vals) if vals else None


def span_ms(run, name: str) -> Optional[float]:
    """The median device ms (its two CUDA events) of the window's spans named
    `name`."""
    return median(elapsed_ms(s.ev0, s.ev1) for s in window(run, name))


def backward_part(run, part: str) -> Optional[float]:
    """The median device ms of a part of the window's `backward` spans split
    at their child `backward.raster`: "before" (the backward's start to the
    raster's start), "after" (the raster's end to the backward's end)."""
    recs = records()
    raster = children(recs, "backward.raster")
    vals = []
    for b in window(run, "backward", recs):
        r = raster.get(b.id)
        if r is not None:
            vals.append(elapsed_ms(b.ev0, r.ev0) if part == "before"
                        else elapsed_ms(r.ev1, b.ev1))
    return median(vals)
