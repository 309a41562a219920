"""Exponential backoff helper (wait.Backoff analog).

The port's copy of ``k8s_dra_driver_tpu/utils/backoff.py``, whole: the
multi-process gateway's conductor (gateway/procpump.py) retries its
deadline-bounded receives on this schedule.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable


@dataclasses.dataclass
class Backoff:
    """Mirrors the knobs of a readiness backoff (duration 1s, factor
    2, jitter 1, steps 4, cap 10s), plus an overall ``deadline_s``
    wall-clock bound, so retry paths are boundable both by steps and
    by time."""

    duration_s: float = 1.0
    factor: float = 2.0
    jitter: float = 1.0
    steps: int = 4
    cap_s: float = 10.0
    deadline_s: float | None = None

    def delays(self) -> list[float]:
        out, d = [], self.duration_s
        for _ in range(self.steps):
            j = d * self.jitter * random.random() if self.jitter else 0.0
            out.append(min(d + j, self.cap_s))
            d = min(d * self.factor, self.cap_s)
        return out

    def poll(self, fn: Callable[[], bool],
             sleep: Callable[[float], None] = time.sleep,
             clock: Callable[[], float] = time.monotonic) -> bool:
        """Run ``fn`` until it returns True, steps are exhausted, or
        ``deadline_s`` of wall clock has elapsed — whichever bound hits
        first.  Sleeps never overshoot the deadline."""
        start = clock()
        if fn():
            return True
        for delay in self.delays():
            if self.deadline_s is not None:
                remaining = self.deadline_s - (clock() - start)
                if remaining <= 0:
                    return False
                delay = min(delay, remaining)
            sleep(delay)
            if fn():
                return True
        return False


__all__ = ["Backoff"]
