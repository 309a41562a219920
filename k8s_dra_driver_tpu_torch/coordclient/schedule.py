"""Duty-cycle schedule math shared by the coordinator daemon and the
workload-side client (the port's copy of
``k8s_dra_driver_tpu/coordclient/schedule.py``, arithmetic unchanged).

The coordinator publishes a time-division schedule over a *wall-clock*
timebase (``epochMs``): every participant — the daemon's enforcer, each
workload's gate process, cooperative library users — evaluates the same
pure function of ``schedule.json`` and the current time, so no further
coordination traffic is needed to agree on whose turn it is.  This is
the TPU answer to the MPS control pipe continuously arbitrating SM
access (reference cmd/nvidia-dra-plugin/sharing.go:260-271): the
arbitration signal is a published periodic timetable instead of a
daemon round-trip per client decision.

Layout of one cycle (``cycleMs`` wide, repeating since ``epochMs``):

    |<-- w1 window -->|<-- w2 window -->|---- idle ----|
    0                                              cycleMs

Worker windows are proportional to their registration ``weight`` and
collectively occupy ``dutyCyclePercent`` of the cycle; the idle
remainder is the fraction of the chip this claim leaves to *other*
claims sharing it.
"""

from __future__ import annotations

import dataclasses

DEFAULT_CYCLE_MS = 100


@dataclasses.dataclass(frozen=True)
class SlotWindow:
    worker: str
    offset_ms: float          # start within the cycle
    window_ms: float          # duration of this worker's turn

    def contains(self, phase_ms: float) -> bool:
        return self.offset_ms <= phase_ms < self.offset_ms + self.window_ms


def _weight_of(reg: dict) -> float:
    """Registration weight, hardened: ctl/*.json is written by
    untrusted workload containers, so a non-numeric weight degrades to
    the default 1 instead of crashing the daemon's arbitration loop."""
    w = reg.get("weight", 1)
    if isinstance(w, bool) or not isinstance(w, (int, float)):
        return 1.0
    return max(0.0, float(w))


def cycle_ms_for(preemption_ms: int) -> int:
    """The cycle length: the configured preemption quantum, or a
    default short enough that alternation is imperceptible."""
    return preemption_ms if preemption_ms > 0 else DEFAULT_CYCLE_MS


def compute_windows(workers: list[dict], duty_cycle_percent: int,
                    cycle_ms: float) -> list[SlotWindow]:
    """Partition the claim's share of one cycle among workers by weight.

    ``workers`` are registration dicts (``name`` required, ``weight``
    optional, default 1).  Non-positive weights get no window.
    """
    active_ms = cycle_ms * max(0, min(100, duty_cycle_percent)) / 100.0
    weights = [_weight_of(w) for w in workers]
    total = sum(weights)
    out: list[SlotWindow] = []
    offset = 0.0
    for w, weight in zip(workers, weights):
        width = active_ms * weight / total if total > 0 else 0.0
        out.append(SlotWindow(worker=w["name"], offset_ms=offset,
                              window_ms=width))
        offset += width
    return out


def phase_of(schedule: dict, now_ms: float) -> float:
    cycle = float(schedule.get("cycleMs") or DEFAULT_CYCLE_MS)
    epoch = float(schedule.get("epochMs") or 0.0)
    return (now_ms - epoch) % cycle


def active_worker(schedule: dict, now_ms: float) -> str | None:
    """Name of the worker whose turn it is at ``now_ms`` (unix ms), or
    None during the idle remainder / before any registrations."""
    phase = phase_of(schedule, now_ms)
    for slot in schedule.get("slots", []):
        win = SlotWindow(worker=slot["worker"],
                         offset_ms=float(slot.get("offsetMs", 0)),
                         window_ms=float(slot.get("windowMs", 0)))
        if win.contains(phase):
            return win.worker
    return None


def ms_until_turn(schedule: dict, worker: str, now_ms: float) -> float | None:
    """Milliseconds until ``worker``'s next window opens (0 if open
    now); None if the worker has no window in the schedule."""
    phase = phase_of(schedule, now_ms)
    cycle = float(schedule.get("cycleMs") or DEFAULT_CYCLE_MS)
    for slot in schedule.get("slots", []):
        if slot["worker"] != worker:
            continue
        offset = float(slot.get("offsetMs", 0))
        window = float(slot.get("windowMs", 0))
        if window <= 0:
            return None
        if offset <= phase < offset + window:
            return 0.0
        delta = offset - phase
        return delta if delta > 0 else delta + cycle
    return None


def ms_left_in_turn(schedule: dict, worker: str, now_ms: float) -> float:
    """Milliseconds of ``worker``'s current window remaining (0 when
    not currently its turn)."""
    phase = phase_of(schedule, now_ms)
    for slot in schedule.get("slots", []):
        if slot["worker"] != worker:
            continue
        offset = float(slot.get("offsetMs", 0))
        window = float(slot.get("windowMs", 0))
        if offset <= phase < offset + window:
            return offset + window - phase
    return 0.0
