"""Fault-tolerance utilities (the reference's ``train/fault.py``):
straggler detection, step retry and a liveness file.

The monitor keeps an EWMA of step times and flags outliers; ``retry_step``
wraps a train step, restoring the latest checkpoint and replaying on a
hard fault.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than threshold × mean."""

    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 5

    def __post_init__(self):
        self.mean: float | None = None
        self.events: list[tuple[int, float, float]] = []
        self.count = 0

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self.count += 1
        if self.mean is None:
            self.mean = dt
            return False
        flagged = (self.count > self.warmup
                   and dt > self.threshold * self.mean)
        if flagged:
            self.events.append((step, dt, self.mean))
        else:
            # stragglers don't poison the baseline
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
        return flagged

    @property
    def straggler_fraction(self) -> float:
        return len(self.events) / max(self.count, 1)


def retry_step(step_fn: Callable, checkpoint_manager, max_retries: int = 2,
               device=None):
    """Wrap a train step with restore-and-replay on hard faults. The
    restored tree's tensors go to ``device`` (numpy arrays if None)."""

    def wrapped(params, opt_state, batch, step: int):
        attempt = 0
        while True:
            try:
                return step_fn(params, opt_state, batch)
            except Exception:
                attempt += 1
                if attempt > max_retries or checkpoint_manager is None:
                    raise
                _, tree = checkpoint_manager.restore(device=device)
                params, opt_state = tree["params"], tree["opt"]

    return wrapped


class Heartbeat:
    """Liveness file for an external supervisor (touch every step)."""

    def __init__(self, path):
        self.path = path

    def beat(self, step: int):
        pathlib.Path(self.path).write_text(f"{step} {time.time()}\n")
