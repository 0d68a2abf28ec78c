"""Graceful preemption: checkpoint-and-exit on SIGTERM.

Preemptible/spot VMs receive SIGTERM shortly before forced shutdown.
The reference has no recovery story at all (SURVEY §5: torch.save per epoch,
no resume path in either trainer, train.py:351-363); here a preemption
becomes a clean mid-epoch checkpoint carrying the exact resume position
{epoch, opt_step_in_epoch, host_step}, and the restarted run's metric
stream is bit-identical to an unbroken one (resume machinery + tests in
tests/test_train.py).  `Trainer.fit` polls the guard once per optimizer
step, drains pending device metrics, saves synchronously (wait=True — the
write must be durable before the VM dies), and returns with
``result["preempted"] = True``.

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/train/preemption.py.
"""
from __future__ import annotations

import signal
import threading
from typing import Tuple


class PreemptionGuard:
    """Turns termination signals into a cooperative flag.

    Use as a context manager: installs handlers for `signals` (default
    SIGTERM) that set an internal event instead of killing the process,
    and restores the previous handlers on exit.  Signal handlers can only
    be installed from the main thread; elsewhere __enter__ degrades to a
    no-op and the flag can still be raised programmatically via
    ``request()`` (which is also what tests do).
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev = {}

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self, signum=None, frame=None) -> None:
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._prev[s] = signal.signal(s, self.request)
        return self

    def __exit__(self, *exc) -> bool:
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
        return False
