"""Spans: the port's stages as named, nested intervals on the host's and the
device's clocks.

A span has a name; a start and an end by `time.perf_counter_ns()` and, once
CUDA is initialised, by `torch.cuda.Event(enable_timing=True)`s recorded on
the stream current at its start (device times are resolved only when read,
after a synchronise: `Span.device_ms`, `elapsed_ms`); its parent span; its
root's id (a train step or a network-GUI request: every span of one step
shares it); and the counters added while it was open (`Span.count`).

Spans record only while a torch.profiler session runs (the module global
`torch.autograd.profiler._is_profiler_enabled`): a benchmark's traced
window, the training loop's `--profile_dir` steps. A recorded span also
enters `torch.profiler.record_function("gsplat.<name>")`, so the profiler's
Chrome trace carries it beside the kernels. Without a profiler a span site
costs that one check: no event, no record_function, no allocation (a site
with a stage listener calls it, as it did before spans). Finished spans
go into one ring of the last `RING` spans of the process (`records()`).

Stage listeners: `span(name, on_stage)` calls `on_stage(name)` when the
span closes without an exception, whether it records or not. The
`on_stage(name)` hooks of render, the train step and the mesh steps (a
caller's timer of the stages) are listeners of these stage ends.

Parents: each thread keeps a stack of its open spans. A span opened on a
thread with none open takes as its parent the innermost open span that
adopts (`adopt=True`: the train step's `backward`, whose functions the
autograd engine runs on its device threads while the training thread waits
in `torch.autograd.grad`), unless it opens as a root (`root=True`: a step,
a request, or a request parsed on a network-GUI connection thread).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

RING = 1 << 16
PREFIX = "gsplat."

_ring: Deque["Span"] = deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()
_adopting: List["Span"] = []
_labels: Dict[str, str] = {}
_NULL = contextlib.nullcontext()


def _stack() -> List["Span"]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _event(stream):
    if stream is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def elapsed_ms(a, b) -> Optional[float]:
    """Device milliseconds from event a to event b (after a synchronise), or
    None where either is missing or was never recorded."""
    if a is None or b is None:
        return None
    try:
        return a.elapsed_time(b)
    except RuntimeError:
        return None


class Span:
    """One recorded interval; see the module's docstring."""

    __slots__ = ("name", "id", "parent", "root", "t0", "t1", "ev0", "ev1", "counters",
                 "_on_stage", "_is_root", "_adopt", "_rf", "_stream")

    def __init__(self, name: str, on_stage=None, root: bool = False, adopt: bool = False):
        self.name, self._on_stage, self._is_root, self._adopt = name, on_stage, root, adopt
        self.counters: Dict[str, object] = {}
        self.t1 = self.ev1 = None

    def __enter__(self) -> "Span":
        stack = _stack()
        parent = None
        if stack and not self._is_root:
            parent = stack[-1]
        elif not self._is_root:
            try:
                parent = _adopting[-1]
            except IndexError:      # none open, or the last closed meanwhile
                pass
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        label = _labels.get(self.name) or _labels.setdefault(self.name, PREFIX + self.name)
        self._rf = torch.profiler.record_function(label)
        self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        # the current stream, looked up once (it costs as much as an event)
        self._stream = torch.cuda.current_stream() if torch.cuda.is_initialized() else None
        self.ev0 = _event(self._stream)
        stack.append(self)
        if self._adopt:
            _adopting.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.ev1 = _event(self._stream)
        self.t1 = time.perf_counter_ns()
        self._stream = None
        _stack().pop()             # a thread's spans close in the order they opened
        if self._adopt:
            _adopting.remove(self)
        self._rf.__exit__(None, None, None)
        self._rf = None
        _ring.append(self)
        on_stage, self._on_stage = self._on_stage, None
        if exc_type is None and on_stage is not None:
            on_stage(self.name)
        return False

    def count(self, **values) -> None:
        """Add each value to the counter of its name (a device scalar stays on
        the device until read)."""
        for k, v in values.items():
            self.counters[k] = self.counters[k] + v if k in self.counters else v

    def host_ms(self) -> Optional[float]:
        return None if self.t1 is None else (self.t1 - self.t0) * 1e-6

    def device_ms(self) -> Optional[float]:
        return elapsed_ms(self.ev0, self.ev1)


class _Stage:
    """A stage end without a recording: calls its listener on a clean exit."""

    __slots__ = ("name", "on_stage")

    def __init__(self, name: str, on_stage: Callable[[str], None]):
        self.name, self.on_stage = name, on_stage

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.on_stage(self.name)
        return False


def span(name: str, on_stage: Optional[Callable[[str], None]] = None, *, root: bool = False,
         adopt: bool = False):
    """A context manager over one stage: a recording `Span` (what `with ...
    as sp` binds) while a profiler runs, else None bound. on_stage(name) is
    called when it closes cleanly; root: no parent; adopt: threads with no
    open span parent their spans on it while it is open."""
    if _profiler._is_profiler_enabled:
        return Span(name, on_stage, root, adopt)
    return _NULL if on_stage is None else _Stage(name, on_stage)


def stage(on_stage: Optional[Callable[[str], None]], name: str) -> None:
    """A stage end that closes no span of its own: on_stage(name), if given."""
    if on_stage is not None:
        on_stage(name)


def records() -> List[Span]:
    """The finished spans the ring holds, oldest first."""
    return list(_ring)


def clear() -> None:
    _ring.clear()
