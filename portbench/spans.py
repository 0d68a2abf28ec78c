"""Host spans the benchmark sets around its calls into the program's
layers.

A span records its host-clock start and end, from whichever thread makes
the call; spans are kept in memory and read once the window has closed (a
trace names its idle gaps by them, trace.py).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Tuple


class Spans:
    def __init__(self):
        self._lock = threading.Lock()
        self.times: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.times[name].append((t0, t1))
