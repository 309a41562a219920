"""Virtual time: the shared injected clock and the discrete-event heap.

The port's copy of ``k8s_dra_driver_tpu/sim/clock.py``, whole:

- :class:`VirtualClock` — the injected-time primitive the load
  generator's replays use (gateway/loadgen.py re-exports it).
  Anything clock-injected in the port (gateways, replays) accepts one.
- :class:`EventHeap` — a discrete-event scheduler: callbacks are keyed
  ``(time, seq)`` on a binary heap, time jumps from event to event,
  and advancing across an idle hour pops NOTHING.

Determinism contract: ties at one timestamp fire in scheduling order
(``seq`` is a monotone counter), callbacks never read wall time, and
no randomness lives here.
"""

from __future__ import annotations

import heapq


class VirtualClock:
    """Injected time for hermetic, fully deterministic replays: the
    gateway and the replay loop share one instance; ``sleep`` advances
    it instead of blocking, so a replay with a virtual clock runs at
    CPU speed with bit-identical scheduling across runs (the seeded-
    bus determinism test rides this)."""

    def __init__(self, t: float = 0.0, step_cost_s: float = 0.0):
        self.t = t
        # optional fixed cost charged per clock read — models a pump
        # step taking nonzero time so overload math stays meaningful
        # under virtual time
        self.step_cost_s = step_cost_s

    def __call__(self) -> float:
        self.t += self.step_cost_s
        return self.t

    def sleep(self, dt: float) -> None:
        if dt > 0:
            self.t += dt


class EventHeap:
    """A seeded-deterministic discrete-event scheduler.

    ``at(t, fn, *args)`` schedules a callback; ``advance_to(t)`` pops
    and runs every due event in ``(time, seq)`` order, then parks the
    clock at ``t``.  Costs are proportional to events POPPED, never to
    time ELAPSED or entities EXISTING.

    The heap owns a :class:`VirtualClock` so clock-injected policy
    objects (reconcilers built with ``clock=heap.clock``) read the
    same virtual now the events fire at.  ``processed`` counts pops —
    the observable the O(events) pin asserts on.
    """

    def __init__(self, t0: float = 0.0):
        self.clock = VirtualClock(t0)
        self._heap: list[tuple[float, int, object, tuple]] = []
        self._seq = 0
        #: events popped so far — the O(events) observable
        self.processed = 0

    @property
    def now(self) -> float:
        return self.clock.t

    def __len__(self) -> int:
        return len(self._heap)

    def at(self, t: float, fn, *args) -> None:
        """Schedule ``fn(*args)`` at virtual time ``t`` (clamped to
        now: the past is immutable, a late event fires immediately on
        the next advance)."""
        heapq.heappush(self._heap,
                       (max(float(t), self.now), self._seq, fn, args))
        self._seq += 1

    def after(self, dt: float, fn, *args) -> None:
        self.at(self.now + max(0.0, float(dt)), fn, *args)

    def next_time(self) -> float | None:
        """Timestamp of the earliest pending event, or None."""
        return self._heap[0][0] if self._heap else None

    def advance_to(self, t: float,
                   max_events: int = 10_000_000) -> int:
        """Run every event due at or before ``t``; park the clock at
        ``t``.  Returns the number of events processed.  Callbacks may
        schedule further events (including at the current instant —
        they fire within the same advance), so the runaway backstop
        lives HERE, inside the pop loop: a same-instant reschedule
        cycle would otherwise never return to the caller's check."""
        t = float(t)
        n0 = self.processed
        while self._heap and self._heap[0][0] <= t:
            if self.processed - n0 >= max_events:
                raise RuntimeError(
                    f"event heap exceeded {max_events} events")
            when, _, fn, args = heapq.heappop(self._heap)
            # events fire AT their own timestamp, not at the target
            if when > self.clock.t:
                self.clock.t = when
            self.processed += 1
            fn(*args)
        if t > self.clock.t:
            self.clock.t = t
        return self.processed - n0

    def run(self, until: float | None = None,
            max_events: int = 10_000_000) -> int:
        """Drain the heap (optionally bounded by ``until``), with a
        runaway backstop shared across every advance."""
        n0 = self.processed
        while self._heap:
            nxt = self._heap[0][0]
            if until is not None and nxt > until:
                break
            self.advance_to(nxt,
                            max_events - (self.processed - n0))
        if until is not None and until > self.clock.t:
            self.clock.t = until
        return self.processed - n0


__all__ = ["EventHeap", "VirtualClock"]
