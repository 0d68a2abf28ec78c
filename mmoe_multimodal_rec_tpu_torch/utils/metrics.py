"""Structured metrics + step timing.

Replaces the reference's rank-0 print logging (train.py:307-310) with a
JSONL metrics stream (one dict per optimizer step / eval event) plus an
examples-per-second meter — the BASELINE.json north-star metric.

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/utils/metrics.py.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def log(self, record: Dict[str, Any]) -> None:
        record = {k: (float(v) if hasattr(v, "item") or
                      isinstance(v, (int, float)) else v)
                  for k, v in record.items()}
        record.setdefault("ts", time.time())
        if self._f:
            self._f.write(json.dumps(record) + "\n")
        if self.echo:
            parts = " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in record.items()
                             if k != "ts")
            print(parts, flush=True)

    def close(self):
        if self._f:
            self._f.close()


class Throughput:
    """Rolling examples/sec meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._examples = 0

    def update(self, n_examples: int) -> None:
        self._examples += n_examples

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._examples / dt if dt > 0 else 0.0
