"""Fault tolerance & straggler mitigation utilities (a copy of
``repro/train/fault.py``, which is pure Python).

On a real multi-host pod the failure modes are: host crash (handled by
checkpoint/restart — the coordinator restarts the job and every host calls
``restore``), hung collective (handled by the watchdog timeout below), and
persistent stragglers (handled by step-time anomaly detection feeding the
operator/autoscaler decision to evict a host and resume on a smaller mesh —
which our elastic checkpoint restore supports directly).

Everything here is host-side control plane: pure Python, no device state,
fully unit-testable without hardware.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass
class StragglerDetector:
    """EWMA step-time anomaly detector.

    ``update`` returns True when the current step is ``threshold`` x slower
    than the running mean — the trainer logs it, and after ``evict_after``
    consecutive anomalies recommends eviction/rescale (the decision is
    surfaced, not auto-executed: the reconfiguration is the platform's job; ours is to detect and to be restartable at any step).
    """

    alpha: float = 0.1
    threshold: float = 2.0
    evict_after: int = 5
    _mean: float = 0.0
    _n: int = 0
    _consecutive: int = 0

    def update(self, step_seconds: float) -> bool:
        self._n += 1
        if self._n <= 3:  # warmup: compile steps are slow
            self._mean = step_seconds if self._mean == 0 else self._mean
            return False
        slow = step_seconds > self.threshold * max(self._mean, 1e-9)
        self._mean = (1 - self.alpha) * self._mean + self.alpha * step_seconds
        self._consecutive = self._consecutive + 1 if slow else 0
        return slow

    @property
    def should_evict(self) -> bool:
        return self._consecutive >= self.evict_after


class Watchdog:
    """Deadline watchdog around device computations.

    A hung collective never returns; ``arm`` starts a timer that fires
    ``on_timeout`` (default: raises in the main thread via a flag the train
    loop checks) unless ``disarm`` is called first.
    """

    def __init__(self, timeout_s: float, on_timeout=None):
        self.timeout_s = timeout_s
        self.expired = False
        self._timer: threading.Timer | None = None
        self._on_timeout = on_timeout

    def _fire(self):
        self.expired = True
        if self._on_timeout:
            self._on_timeout()

    def arm(self):
        self.disarm()
        self.expired = False
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def __enter__(self):
        self.arm()
        return self

    def __exit__(self, *exc):
        self.disarm()
        return False
