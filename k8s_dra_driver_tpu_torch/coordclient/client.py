"""Workload-side coordinator client: membership only.

The port's copy of the registration half of ``k8s_dra_driver_tpu/
coordclient/client.py``: a worker registers with its claim's
coordination directory and heartbeats there, so a supervisor can tell
a live worker from a SIGKILLed one by the file's age.  The files and
keys are the reference's (``<dir>/ctl/<name>.json`` holding ``pid``,
``weight``, ``registeredAtMs`` and ``heartbeatAtMs``), so either
package's supervisor reads either package's workers.  The duty-cycle
schedule and device-memory limits are not ported here.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

from ..utils.atomicio import write_atomic

ENV_COORDINATION_DIR = "TPU_COORDINATOR_DIR"
#: the file a coordinator daemon publishes in its coordination dir once
#: it serves (the plugin's readiness watch, plugin/sharing.py)
READY_FILE = "ready"

#: how often a live client refreshes its registration; a daemon
#: evicts anything silent for 15 s, so this stays well inside it
HEARTBEAT_INTERVAL_S = 3.0


def _now_ms() -> float:
    return time.time() * 1000.0


class CoordinatorClient:
    """One workload's registration in its claim's coordination
    directory.  ``name`` identifies the worker across restarts;
    ``weight`` biases its share of the claim's duty cycle."""

    def __init__(self, coordination_dir: str | Path | None = None, *,
                 name: str | None = None, weight: float = 1.0,
                 now_ms=_now_ms):
        if coordination_dir is None:
            coordination_dir = os.environ.get(ENV_COORDINATION_DIR)
        if not coordination_dir:
            raise ValueError(
                f"no coordination dir: pass one or set {ENV_COORDINATION_DIR}")
        self.dir = Path(coordination_dir)
        self.name = name or f"w{os.getpid()}"
        self.weight = weight
        self._now_ms = now_ms
        self._registered: dict | None = None
        self._last_heartbeat_ms: float = 0.0

    @classmethod
    def from_env(cls, environ: dict | None = None,
                 **kw) -> "CoordinatorClient | None":
        """Client for the claim this process was prepared with, or None
        when the environment names no coordination dir."""
        env = environ if environ is not None else os.environ
        if not env.get(ENV_COORDINATION_DIR):
            return None
        return cls(env[ENV_COORDINATION_DIR], **kw)

    @property
    def _reg_path(self) -> Path:
        return self.dir / "ctl" / f"{self.name}.json"

    def register(self, pid: int | None = None,
                 hbm_limit_bytes: int | None = None,
                 pid_is_group: bool = False) -> None:
        """Drop this worker's registration file."""
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
        """Refresh the registration (``heartbeatAtMs``)."""
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
        """Heartbeat if ``HEARTBEAT_INTERVAL_S`` has elapsed."""
        if self._registered is None:
            return
        if self._now_ms() - self._last_heartbeat_ms >= \
                HEARTBEAT_INTERVAL_S * 1000:
            self.heartbeat()

    def unregister(self) -> None:
        self._reg_path.unlink(missing_ok=True)
        self._registered = None


__all__ = ["CoordinatorClient", "ENV_COORDINATION_DIR",
           "HEARTBEAT_INTERVAL_S"]
