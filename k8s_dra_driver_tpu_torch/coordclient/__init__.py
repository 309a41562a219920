"""Workload-side coordination: the consumer half of shared claims.

``CoordinatorClient`` and the gate (``python -m
k8s_dra_driver_tpu_torch.coordclient.gate``) give coordinated claims
real duty-cycle arbitration; ``TimeshareGate`` gives plain time-sliced
claims kernel-enforced mutual exclusion per preemption quantum, one
lock a TPU chip or a GPU UUID.  Schedule math lives in ``schedule`` and
is shared with the daemon (cmd/coordinatord.py).  Nothing here imports
torch."""

from .client import ENV_COORDINATION_DIR, CoordinatorClient
from .gate import ENV_PREEMPTION_MS, ENV_TIMESHARE_DIR, TimeshareGate, main
from .schedule import (DEFAULT_CYCLE_MS, SlotWindow, active_worker,
                       compute_windows, cycle_ms_for, ms_left_in_turn,
                       ms_until_turn)

__all__ = [
    "ENV_COORDINATION_DIR", "ENV_PREEMPTION_MS", "ENV_TIMESHARE_DIR",
    "CoordinatorClient", "TimeshareGate", "main",
    "DEFAULT_CYCLE_MS", "SlotWindow", "active_worker", "compute_windows",
    "cycle_ms_for", "ms_left_in_turn", "ms_until_turn",
]
