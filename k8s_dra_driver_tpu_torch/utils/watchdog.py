"""Deadline/stall watchdog and worker heartbeat files.

The port's copy of ``k8s_dra_driver_tpu/utils/watchdog.py``, same
names, verdicts and heartbeat file format, so a monitor of either
package classifies the other's heartbeats.  A wedged step may never
return, so the only safe way to wait on it is from outside, and the
only truthful "this step really finished" signal is a scalar readback
(``float(loss)``).  Two pieces:

- :func:`run_with_deadline` — run a callable in a watchdog thread and
  raise :class:`WatchdogTimeout` in the caller when the deadline
  passes.  CPython cannot kill the stuck thread; the caller must make
  the region abortable (the gang supervisor's abort event,
  parallel/supervisor.py) or be about to exit anyway.

- worker heartbeat files — each gang worker writes a tiny JSON record
  (step, phase, wall time) under the claim's coordination dir;
  :class:`HeartbeatMonitor` classifies a worker as ``ok``/``slow``
  (progressing, but over the soft deadline), ``wedged`` (heartbeat
  stale past the hard deadline with no exit evidence: the process is
  presumed alive but stuck below Python), or ``dead`` (an explicit
  tombstone recorded by the worker's own teardown or the bed that
  killed it).  The supervisor evicts on ``dead``/``wedged`` and merely
  records ``slow``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

# classification verdicts (HeartbeatMonitor.classify)
OK = "ok"
SLOW = "slow"
WEDGED = "wedged"
DEAD = "dead"
MISSING = "missing"


class WatchdogTimeout(TimeoutError):
    """A supervised region outlived its deadline (presumed wedged)."""

    def __init__(self, label: str, deadline_s: float):
        self.label = label
        self.deadline_s = deadline_s
        super().__init__(
            f"{label} did not finish within {deadline_s:g}s "
            "(presumed wedged; the stuck thread cannot be killed — "
            "abort or evict the region it supervises)")


def run_with_deadline(fn, deadline_s: float, *,
                      label: str = "supervised region"):
    """Run ``fn()`` under a wall-clock deadline.

    Returns ``fn``'s result, re-raises its exception, or raises
    :class:`WatchdogTimeout` after ``deadline_s`` — the caller gets
    control back even when ``fn`` never would.  The worker thread is
    a daemon: a region that later unwedges finishes into the void
    (its result is discarded), and one that never does cannot block
    process exit.
    """
    done = threading.Event()
    box: dict = {}

    def _target():
        try:
            box["value"] = fn()
        except BaseException as e:        # surfaced to the caller
            box["error"] = e
        finally:
            done.set()

    thread = threading.Thread(target=_target, daemon=True,
                              name=f"watchdog:{label}")
    thread.start()
    if not done.wait(deadline_s):
        raise WatchdogTimeout(label, deadline_s)
    if "error" in box:
        raise box["error"]
    return box.get("value")


# --------------------------------------------------------------------------
# worker heartbeat files
# --------------------------------------------------------------------------

def _atomic_write(path: Path, payload: dict) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(payload))
    os.replace(tmp, path)        # readers never see a torn record


def heartbeat_path(directory: Path | str, worker: str) -> Path:
    return Path(directory) / f"{worker}.heartbeat.json"


class WorkerHeartbeat:
    """Writer side: one worker's liveness record under the gang's
    coordination dir.  ``beat`` marks progress (step + phase —
    heartbeats come from the worker's side thread in a real gang, so
    a wedged collective still beats with a *stuck step*, while a
    stale timestamp means the whole process stopped scheduling);
    ``tombstone`` records an observed exit so the supervisor can tell
    ``dead`` from ``wedged``."""

    def __init__(self, directory: Path | str, worker: str):
        self.worker = worker
        self.path = heartbeat_path(directory, worker)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int, phase: str = "step") -> None:
        _atomic_write(self.path, {"worker": self.worker, "step": step,
                                  "phase": phase, "t": time.time()})

    def tombstone(self, exit_code: int) -> None:
        _atomic_write(self.path, {"worker": self.worker,
                                  "exit": exit_code, "t": time.time()})


class HeartbeatMonitor:
    """Supervisor side: classify workers from their heartbeat files.

    ``soft_s``: a fresh heartbeat older than this is ``slow`` (worth a
    metric, not an eviction).  ``hard_s``: staler than this with no
    tombstone is ``wedged`` — no schedule activity for a whole
    deadline means the process is stuck below Python (the wedged
    tunnel), not merely busy.
    """

    def __init__(self, directory: Path | str, *, soft_s: float,
                 hard_s: float):
        if hard_s < soft_s:
            raise ValueError(f"hard_s {hard_s} < soft_s {soft_s}")
        self.directory = Path(directory)
        self.soft_s = soft_s
        self.hard_s = hard_s

    def read(self, worker: str) -> dict | None:
        try:
            return json.loads(heartbeat_path(self.directory,
                                             worker).read_text())
        except (OSError, ValueError):
            return None

    def classify(self, worker: str, now: float | None = None) -> str:
        rec = self.read(worker)
        if rec is None:
            return MISSING
        if "exit" in rec:
            return DEAD
        age = (time.time() if now is None else now) - rec.get("t", 0.0)
        if age >= self.hard_s:
            return WEDGED
        if age >= self.soft_s:
            return SLOW
        return OK


__all__ = ["DEAD", "MISSING", "OK", "SLOW", "WEDGED",
           "HeartbeatMonitor", "WatchdogTimeout", "WorkerHeartbeat",
           "heartbeat_path", "run_with_deadline"]
