"""The device timeline of a traced window, from torch.profiler.

`Trace.start()` / `Trace.stop()` bracket the window (the device drained at
both ends).  Read from the profiler's events afterwards:
- busy_s: the length of the union of the intervals in which an operation
  (a kernel, a copy, a fill) ran on the device;
- window_s: the window's length on the host clock;
- seconds of device time by operation name;
- the longest idle gaps between device intervals, each named by the
  innermost benchmark span (spans.py, any thread) open on the host at the
  gap's midpoint; the spans' host clock is put on the profiler's wall clock
  by one reading of both taken when the trace starts.
A driver traces a part of its window (the mix's `trace_steps` or
`trace_seconds`), so that reading the trace stays short.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple


def _device_intervals(prof) -> List[Tuple[float, float, str]]:
    """(start, end, name) in microseconds of the profiler's clock (the wall
    clock) of every device operation, read from the profiler's raw events
    (building its event tree takes minutes for a training step's hundreds
    of thousands of host operations)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            s = e.start_ns() / 1e3
            out.append((s, s + e.duration_ns() / 1e3, e.name()))
    return out


def summarize(dev, host):
    """(busy seconds, device seconds by operation, the 10 longest idle gaps
    as (innermost host span open at the gap's midpoint, seconds)) from
    device and host intervals (start, end, name) in microseconds."""
    dev = sorted(dev)
    op_s: Dict[str, float] = {}
    merged: List[List[float]] = []
    for s, e, name in dev:
        op_s[name] = op_s.get(name, 0.0) + (e - s) / 1e6
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e6
    host = sorted(host)
    starts = [h[0] for h in host]
    gaps = sorted(((b - a, a) for (_, a), (b, _) in zip(merged, merged[1:])),
                  reverse=True)
    named = []
    for length, a in gaps[:10]:
        at = a + length / 2
        i = bisect.bisect_right(starts, at)
        best = None
        for s, e, n in host[:i]:
            if s <= at < e and (best is None or s >= best[0]):
                best = (s, n)
        named.append((best[1] if best else "host", length / 1e6))
    return busy, op_s, named


class Trace:
    def __init__(self):
        self.prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.op_s: Dict[str, float] = {}
        self.gaps: List[Tuple[str, float]] = []

    @staticmethod
    def warm() -> None:
        """Starts and stops the profiler once (in set-up): its first start
        initialises the device tracer, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        # the device's activity only: recording every host operation as
        # well slowed the ranking cell's packer by 40-80% while traced
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        self.wall0_us = time.time_ns() / 1e3

    def stop(self, spans) -> None:
        """Ends the window; `spans` (spans.Spans) name the idle gaps."""
        import torch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        t = time.perf_counter()
        dev = _device_intervals(self.prof)
        self.prof = None
        if not dev:
            raise RuntimeError("the trace holds no device operation")
        wall = lambda pc: self.wall0_us + (pc - self.t0) * 1e6
        host = [(wall(a), wall(b), name) for name, ts in spans.times.items()
                for a, b in ts]
        self.busy_s, self.op_s, self.gaps = summarize(dev, host)
        self.read_s = time.perf_counter() - t

    def breakdown(self) -> Dict[str, list]:
        top = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in self.gaps]}
