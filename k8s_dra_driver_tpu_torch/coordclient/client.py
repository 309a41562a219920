"""Workload-side coordinator client.

The port of ``k8s_dra_driver_tpu/coordclient/client.py``: a workload (or
the gate wrapping it, ``coordclient/gate.py``) registers with its
claim's coordinator daemon (``cmd/coordinatord.py``) through the
bind-mounted coordination directory, heartbeats there, and gates its
compute on the published duty-cycle schedule.  The files and keys are
the reference's (``<dir>/ctl/<name>.json`` holding ``pid``, ``weight``,
``registeredAtMs`` and ``heartbeatAtMs``; ``ready``; ``schedule.json``),
so either package's daemon schedules either package's workers.

Three usage tiers, strongest first:

1. **Gate process** (``python -m k8s_dra_driver_tpu_torch.coordclient.gate
   exec -- cmd``): runs the workload as a child and SIGSTOP/SIGCONTs it
   outside its window.
2. **Cooperative library** (``CoordinatorClient.duty_cycles()``): a
   training loop yields between steps only while its window is open.
3. **Daemon-side enforcement** (``coordinatord --enforce``): when the
   daemon shares a PID namespace with the workloads it signals the
   registered pids itself.

The device-memory budget is the one place the card differs from the
TPU: the reference writes XLA's client flags, which PyTorch never
reads; ``apply_hbm_env`` writes the CUDA caching allocator's
``per_process_memory_fraction`` option instead.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

from . import schedule as sched
from ..utils.atomicio import write_atomic

ENV_COORDINATION_DIR = "TPU_COORDINATOR_DIR"
SCHEDULE_FILE = "schedule.json"
#: the file a coordinator daemon publishes in its coordination dir once
#: it serves (the plugin's readiness watch, plugin/sharing.py)
READY_FILE = "ready"
#: the CUDA caching allocator's options, read once when the allocator
#: starts (comma-separated ``key:value`` pairs)
ENV_ALLOC_CONF = "PYTORCH_CUDA_ALLOC_CONF"
ALLOC_FRACTION_KEY = "per_process_memory_fraction"

#: how often a live client refreshes its registration; the daemon
#: evicts anything silent for coordinatord.DEFAULT_STALE_AFTER_S (15s),
#: so this must stay comfortably inside that.
HEARTBEAT_INTERVAL_S = 3.0

#: short-start exponential poll for the wait_* loops: the daemon
#: publishes its ready and schedule files within milliseconds of
#: starting, so start at 2 ms and back off to a 50 ms steady state: a
#: ready daemon is seen at once, a slow one costs no more polling.
POLL_START_S = 0.002
POLL_CAP_S = 0.05


def _next_delay(delay: float) -> float:
    return min(delay * 2.0, POLL_CAP_S)


def _now_ms() -> float:
    return time.time() * 1000.0


def hbm_fraction(limit_bytes: int, total_bytes: int) -> float:
    """The share of the card a byte budget is, clamped to [0.01, 1]
    (the reference's clamp of its XLA memory fraction)."""
    return max(0.01, min(1.0, limit_bytes / total_bytes))


def merge_alloc_conf(current: str, fraction: float) -> str:
    """``PYTORCH_CUDA_ALLOC_CONF`` with ``per_process_memory_fraction``
    set to ``fraction``, every other option of ``current`` kept in its
    order."""
    kept = [part.strip() for part in current.split(",")
            if part.strip() and part.split(":", 1)[0].strip()
            != ALLOC_FRACTION_KEY]
    return ",".join(kept + [f"{ALLOC_FRACTION_KEY}:{fraction:.3f}"])


class CoordinatorClient:
    """One workload's connection to its claim's coordinator daemon.

    ``name`` identifies the worker across restarts (slot assignment is
    name-ordered in the daemon); ``weight`` biases this worker's share
    of the claim's duty cycle relative to its siblings.
    """

    def __init__(self, coordination_dir: str | Path | None = None, *,
                 name: str | None = None, weight: float = 1.0,
                 now_ms=_now_ms, sleep=time.sleep):
        if coordination_dir is None:
            coordination_dir = os.environ.get(ENV_COORDINATION_DIR)
        if not coordination_dir:
            raise ValueError(
                f"no coordination dir: pass one or set {ENV_COORDINATION_DIR}")
        self.dir = Path(coordination_dir)
        self.name = name or f"w{os.getpid()}"
        self.weight = weight
        self._now_ms = now_ms
        self._sleep = sleep
        self._registered: dict | None = None
        self._last_heartbeat_ms: float = 0.0

    @classmethod
    def from_env(cls, environ: dict | None = None,
                 **kw) -> "CoordinatorClient | None":
        """Client for the claim this process was prepared with, or None
        when the environment names no coordination dir (an exclusive,
        non-coordinated claim: nothing to register with).  Callers with
        CDI mounts resolve the dir through
        ``gateway.resolve_container_path`` first."""
        env = environ if environ is not None else os.environ
        if not env.get(ENV_COORDINATION_DIR):
            return None
        return cls(env[ENV_COORDINATION_DIR], **kw)

    # -- registration --------------------------------------------------

    @property
    def _reg_path(self) -> Path:
        return self.dir / "ctl" / f"{self.name}.json"

    def register(self, pid: int | None = None,
                 hbm_limit_bytes: int | None = None,
                 pid_is_group: bool = False) -> None:
        """Drop this worker's registration file; the daemon folds it
        into the next published schedule.  ``pid_is_group`` tells a
        daemon-side enforcer it may signal the whole process group
        (the gate sets it: its children are session leaders)."""
        reg = {"pid": pid if pid is not None else os.getpid(),
               "weight": self.weight,
               "registeredAtMs": self._now_ms()}
        if pid_is_group:
            reg["pidIsGroup"] = True
        if hbm_limit_bytes is not None:
            reg["hbmLimitBytes"] = int(hbm_limit_bytes)
        self._reg_path.parent.mkdir(parents=True, exist_ok=True)
        write_atomic(self._reg_path, json.dumps(reg))
        self._registered = reg
        self._last_heartbeat_ms = self._now_ms()

    def heartbeat(self, hbm_bytes_in_use: int | None = None) -> None:
        """Refresh the registration (``heartbeatAtMs``); reporting
        device-memory use here is what lets the daemon detect limit
        violations (status.json ``violations``)."""
        if self._registered is None:
            self.register()
        reg = dict(self._registered)
        reg["heartbeatAtMs"] = self._now_ms()
        if hbm_bytes_in_use is not None:
            reg["hbmBytesInUse"] = int(hbm_bytes_in_use)
        write_atomic(self._reg_path, json.dumps(reg))
        self._registered = reg
        self._last_heartbeat_ms = self._now_ms()

    def maybe_heartbeat(self) -> None:
        """Heartbeat if ``HEARTBEAT_INTERVAL_S`` has elapsed: called
        from the gating loops so a live worker is never mistaken for a
        SIGKILLed one and evicted by the daemon."""
        if self._registered is None:
            return
        if self._now_ms() - self._last_heartbeat_ms >= \
                HEARTBEAT_INTERVAL_S * 1000:
            self.heartbeat()

    def unregister(self) -> None:
        self._reg_path.unlink(missing_ok=True)
        self._registered = None

    # -- daemon state --------------------------------------------------

    def daemon_ready(self) -> bool:
        return (self.dir / READY_FILE).exists()

    def wait_ready(self, timeout_s: float = 30.0) -> None:
        deadline = self._now_ms() + timeout_s * 1000
        delay = POLL_START_S
        while not self.daemon_ready():
            # keep the registration fresh while we wait: a slow-to-
            # start daemon must not evict us as stale on first sight
            self.maybe_heartbeat()
            if self._now_ms() >= deadline:
                raise TimeoutError(
                    f"coordinator at {self.dir} not ready in {timeout_s}s")
            self._sleep(delay)
            delay = _next_delay(delay)

    def read_schedule(self) -> dict:
        try:
            payload = json.loads((self.dir / SCHEDULE_FILE).read_text())
        except (OSError, ValueError):
            return {}
        return payload if isinstance(payload, dict) else {}

    def wait_scheduled(self, timeout_s: float = 30.0) -> dict:
        """Block until the published schedule contains our slot."""
        deadline = self._now_ms() + timeout_s * 1000
        delay = POLL_START_S
        while True:
            # re-drop the registration if the daemon evicted it while
            # we waited (restart, slow start): else this livelocks
            self.maybe_heartbeat()
            schedule = self.read_schedule()
            if any(s.get("worker") == self.name
                   for s in schedule.get("slots", [])):
                return schedule
            if self._now_ms() >= deadline:
                raise TimeoutError(
                    f"worker {self.name} never appeared in schedule")
            self._sleep(delay)
            delay = _next_delay(delay)

    # -- duty-cycle gating ---------------------------------------------

    def my_turn(self, schedule: dict | None = None) -> bool:
        schedule = schedule if schedule is not None else self.read_schedule()
        return sched.active_worker(schedule, self._now_ms()) == self.name

    def wait_turn(self, timeout_s: float | None = None) -> float:
        """Block until our window opens; returns ms left in the window."""
        deadline = (self._now_ms() + timeout_s * 1000
                    if timeout_s is not None else None)
        delay = POLL_START_S
        while True:
            self.maybe_heartbeat()
            schedule = self.read_schedule()
            now = self._now_ms()
            wait = sched.ms_until_turn(schedule, self.name, now)
            if wait == 0.0:
                return sched.ms_left_in_turn(schedule, self.name, now)
            if deadline is not None and now >= deadline:
                raise TimeoutError(f"worker {self.name}: window never opened")
            # Unscheduled yet: short-start exponential poll;
            # scheduled: sleep out the gap to the window.
            if wait is None:
                self._sleep(delay)
                delay = _next_delay(delay)
            else:
                self._sleep(min(wait / 1000.0, 0.5))

    def duty_cycles(self, duration_s: float | None = None):
        """Generator for cooperative loops::

            for ms_left in client.duty_cycles():
                run_one_step()   # sized well under the window

        Yields (ms left in the current window) only while our window is
        open, sleeping between windows; stops after ``duration_s``.
        """
        end = self._now_ms() + duration_s * 1000 if duration_s else None
        while True:
            if end is not None and self._now_ms() >= end:
                return
            left = self.wait_turn()
            yield left

    # -- device-memory limits ------------------------------------------

    def hbm_limit_bytes(self) -> int | None:
        """This worker's device-memory budget: its registered limit if
        any, else the claim-wide limit from the schedule (sum over
        devices)."""
        if self._registered and "hbmLimitBytes" in self._registered:
            return self._registered["hbmLimitBytes"]
        limits = self.read_schedule().get("hbmLimits") or {}
        if not limits:
            return None
        return sum(int(v) for v in limits.values())

    def apply_hbm_env(self, total_hbm_bytes: int,
                      environ: dict | None = None) -> dict:
        """Translate the budget into the CUDA caching allocator's
        ``per_process_memory_fraction`` option of
        ``PYTORCH_CUDA_ALLOC_CONF``, merged into any value already set;
        returns the edits made.  Like the reference's XLA flags it must
        be set before the process starts CUDA: the allocator reads it
        once.  ``total_hbm_bytes`` is the card's memory as torch counts
        it (``get_device_properties(0).total_memory``), which the
        fraction is taken of."""
        env = environ if environ is not None else os.environ
        limit = self.hbm_limit_bytes()
        edits: dict[str, str] = {}
        if limit and total_hbm_bytes > 0:
            edits[ENV_ALLOC_CONF] = merge_alloc_conf(
                env.get(ENV_ALLOC_CONF, ""),
                hbm_fraction(limit, total_hbm_bytes))
        env.update(edits)
        return edits


__all__ = ["ALLOC_FRACTION_KEY", "CoordinatorClient", "ENV_ALLOC_CONF",
           "ENV_COORDINATION_DIR", "HEARTBEAT_INTERVAL_S", "POLL_CAP_S",
           "POLL_START_S", "READY_FILE", "SCHEDULE_FILE", "hbm_fraction",
           "merge_alloc_conf"]
