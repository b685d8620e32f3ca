"""Structured training metrics: JSONL event stream + TensorBoard + console
(the port's copy of gsplat_tpu/train/metrics.py).

The reference explicitly ignores TensorBoard ('// ignore tensorboard writer!!',
src/utils/train_utils.cpp:92) and logs only timestamped text. Here every metric
event is appended as one JSON line to <model_path>/metrics.jsonl — trivially
machine-readable (pandas.read_json(lines=True)), works offline — AND every
numeric value is written as a TensorBoard scalar to <model_path>/tb/ via the
dependency-free event-file writer in train/tb.py (upstream 3DGS's
training_report logs the same scalars through torch's SummaryWriter).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricsLogger:
    def __init__(self, model_path: Optional[str] = None):
        self._file = None
        self._tb = None
        if model_path:
            p = Path(model_path)
            p.mkdir(parents=True, exist_ok=True)
            self._file = open(p / "metrics.jsonl", "a", buffering=1)
            from gsplat_tpu_torch.train.tb import TBWriter

            self._tb = TBWriter(p / "tb")

    def log(self, step: int, **values) -> None:
        if self._file is None:
            return
        rec = {"step": step, "ts": time.time(), **values}
        self._file.write(json.dumps(rec) + "\n")
        self._tb.scalars(step, **values)
        self._tb.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
