"""Deterministic in-process event bus for the serving control plane.

The port's copy of ``k8s_dra_driver_tpu/cluster/bus.py``: ``EventBus``
and ``BusTap``, the bridge a pump process of the multi-process gateway
(gateway/procpump.py) ships its local events across.
Producers PUBLISH (prefix hit, drain, demand update) and consumers fold
events at O(events) cost, so the step cost of a quiet control plane
does not grow with pool size.

- **No threads.**  ``publish`` only enqueues; ``pump()`` delivers
  synchronously FIFO in the caller's thread.  The gateway pump
  (gateway/frontend.py) pumps once at the end of its step, so event
  delivery interleaves with control logic deterministically.
- **Seeded, not arbitrary, ordering.**  Delivery is strict FIFO by
  publish order; where the control plane has a free choice it draws
  the order from this bus's seeded RNG via :meth:`shuffle`.

A raising subscriber is isolated (counted in ``errors``): an
observability consumer must never break the pump, the same contract as
``PrefixCache.listeners``.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
from collections import deque
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class Event:
    """One published fact: a monotone sequence number (the total
    order), a topic string, and an immutable-by-convention payload."""

    seq: int
    topic: str
    payload: dict


class EventBus:
    """Seeded single-threaded pub/sub (module docstring).

    ``journal`` keeps the last N delivered events — the determinism
    tests' evidence that two same-seed runs delivered the same event
    sequence, and a debugging trace for chaos failures.
    """

    def __init__(self, seed: int = 0, journal: int = 4096):
        self.seed = seed
        self.rng = random.Random(seed)
        self._subs: dict[str, list[Callable[[Event], Any]]] = {}
        self._q: deque[Event] = deque()
        self._seq = itertools.count()
        self.journal: deque[Event] = deque(maxlen=journal)
        self.published_total = 0
        self.delivered_total = 0
        self.errors = 0

    # -- wiring ----------------------------------------------------------

    def subscribe(self, topic: str,
                  fn: Callable[[Event], Any]) -> None:
        """Register ``fn`` for ``topic``; delivery order among
        subscribers is registration order (deterministic)."""
        self._subs.setdefault(topic, []).append(fn)

    # -- publish / deliver -----------------------------------------------

    def publish(self, topic: str, **payload) -> Event:
        """Enqueue one event; NOTHING is delivered here — the owner's
        next :meth:`pump` delivers, so a publisher can never re-enter
        a consumer mid-decision."""
        ev = Event(next(self._seq), topic, payload)
        self._q.append(ev)
        self.published_total += 1
        return ev

    def pump(self, max_events: int = 100_000) -> int:
        """Deliver queued events FIFO until the queue is empty (events
        published BY subscribers during delivery are appended and
        delivered in the same pump — cascades settle); returns the
        number delivered.  ``max_events`` is a runaway-cascade
        backstop, far above any real step's traffic."""
        delivered = 0
        while self._q and delivered < max_events:
            ev = self._q.popleft()
            self.journal.append(ev)
            self.delivered_total += 1
            delivered += 1
            for fn in list(self._subs.get(ev.topic, ())):
                try:
                    fn(ev)
                except Exception:
                    # a broken tap must not fail the pump (miniapi
                    # notify contract) — but it must be visible
                    self.errors += 1
        return delivered

    # -- seeded scheduling -----------------------------------------------

    def shuffle(self, items) -> list:
        """A seeded permutation for genuinely-free control-plane
        choices (pump service order, steal victim order): same seed →
        same sequence of permutations → replayable chaos runs."""
        out = list(items)
        self.rng.shuffle(out)
        return out

    # -- introspection ---------------------------------------------------

    def topics(self) -> list[str]:
        return sorted(self._subs)

    def journal_topics(self) -> list[str]:
        """The delivered-event topic sequence (determinism tests
        compare this across same-seed runs)."""
        return [ev.topic for ev in self.journal]

    def journal_dump(self, limit: int | None = None) -> list[dict]:
        """JSON-safe journal records ``{seq, topic, payload}`` —
        payloads SUMMARIZED (:func:`_safe`: bounded depth, truncated
        sequences, repr'd objects) so chaos replay and the flight
        recorder can reconstruct what happened without
        ``journal_topics``'s payload amnesia.  ``limit`` keeps only the
        newest N."""
        events = list(self.journal)
        if limit is not None:
            events = events[-limit:]
        return [{"seq": ev.seq, "topic": ev.topic,
                 "payload": _safe(ev.payload)} for ev in events]


class BusTap:
    """Collect events from chosen topics for replay on ANOTHER bus —
    the bridge half of the multi-process gateway (gateway/procpump.py):
    a pump subprocess taps its local bus, ships :meth:`drain`'s JSON-
    safe ``(topic, payload)`` pairs in its step reply, and the
    conductor republishes them fleet-wide tagged with the pump name.
    Payloads are summarized (:func:`_safe`) at capture, because they
    are about to cross a process boundary as JSON."""

    def __init__(self, bus: EventBus, topics):
        self._pending: list = []
        for topic in topics:
            bus.subscribe(topic, self._on_event)

    def _on_event(self, ev: Event) -> None:
        self._pending.append((ev.topic, _safe(ev.payload)))

    def drain(self) -> list:
        out, self._pending = self._pending, []
        return out


#: journal_dump summarization bounds — wide enough that every payload
#: the control plane publishes today survives intact; tight enough
#: that a pathological payload cannot balloon a flight-recorder dump
_SAFE_DEPTH = 4
_SAFE_ITEMS = 8
_SAFE_REPR = 120


def _safe(value, depth: int = _SAFE_DEPTH):
    """Summarize ``value`` into something ``json.dumps`` always
    accepts: plain scalars pass (non-finite floats become strings —
    JSON has no NaN), dicts/sequences recurse depth-bounded with long
    sequences truncated to their head plus a ``"...+N"`` marker, and
    anything else collapses to a truncated ``repr``."""
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        return value if value == value and abs(value) != float("inf") \
            else str(value)
    if depth <= 0:
        return repr(value)[:_SAFE_REPR]
    if isinstance(value, dict):
        return {str(k): _safe(v, depth - 1) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset, deque)):
        items = list(value)
        out = [_safe(v, depth - 1) for v in items[:_SAFE_ITEMS]]
        if len(items) > _SAFE_ITEMS:
            out.append(f"...+{len(items) - _SAFE_ITEMS}")
        return out
    return repr(value)[:_SAFE_REPR]


__all__ = ["BusTap", "Event", "EventBus"]
