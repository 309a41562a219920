"""Fleet flight recorder: triggered forensic dumps.

The port's copy of ``k8s_dra_driver_tpu/cluster/flightrec.py``.  A
bounded window of evidence (the tracer's span ring, the event bus's
journal, a metrics snapshot) captured as one JSON-safe dict the moment
something goes wrong, so a chaos run or a live incident ships its own
explanation instead of requiring a re-run under print statements:
always recording, dumped on trigger.

Triggers (``default_trigger``, replaceable): an SLO shed reaching
terminal status, a replica drain, a gang eviction / park / FAILED
transition, a reconciler preemption or reclaim, and a burn-rate alert.
Trigger matching rides ``Tracer.sinks`` (synchronous, per span,
exception-isolated), so the recorder sees the same deterministic order
the trace export does.  Cascades coalesce: a trigger of the same kind
arriving less than ``min_new_spans`` spans after the previous dump
annotates that dump instead of duplicating the whole window.

The metrics snapshot is the port's ``utils/metrics.py render_all``,
which writes no ``_created`` samples; that is the only way a dump
differs from the reference's over the same span stream.  On-demand
access is ``debug_payload()``, which builds the same dump without
storing it.
"""

from __future__ import annotations

import json
from collections import deque
from pathlib import Path

from ..utils.metrics import render_all

#: trigger reasons a default recorder can produce ("alert" = a
#: tenant's SLO burn-rate alert, gateway/burnrate.py)
REASONS = ("slo_shed", "drain", "eviction", "failed", "preempt",
           "alert")

#: gang states whose entry is incident-worthy (matched on the span's
#: ``to`` attr, case-insensitive — no import of parallel/supervisor
#: from cluster/)
_GANG_BAD = {"evict": "eviction", "failed": "failed",
             "parked": "preempt"}

#: reconciler action kinds that mark a preemption/reclaim cascade
_RECLAIM_KINDS = {"preempt", "reclaim_park", "reclaim_shrink",
                  "reclaim_drain"}


def default_trigger(rec: dict) -> str | None:
    """Span → trigger reason (None = not incident-worthy)."""
    name = rec.get("name")
    attrs = rec.get("attrs", {})
    if name == "drain":
        return "drain"
    if name == "alert":
        # a burn-rate alert span (gateway/burnrate.py): the tenant is
        # burning SLO budget across both windows — dump with digests
        return "alert"
    if name == "terminal" and attrs.get("status") == "shed_expired":
        return "slo_shed"
    if name == "gang":
        to = str(attrs.get("to", "")).lower()
        return _GANG_BAD.get(to)
    if name == "reconcile":
        kind = str(attrs.get("kind", "")).lower()
        if kind in _RECLAIM_KINDS:
            return "preempt"
    return None


class FlightRecorder:
    """Always-on recorder over a :class:`~..utils.tracing.Tracer`.

    ``metrics`` is any iterable of objects with ``render() -> bytes``
    (utils/metrics.py families, a ``MemWatch``), snapshotted into each
    dump via ``render_all``.  ``dump_dir`` additionally writes each
    stored dump as ``flightrec-<n>-<reason>.json``.  ``capacity``
    bounds the stored dump history (the span ring inside each dump is
    already bounded by the tracer)."""

    def __init__(self, tracer, bus=None, metrics=(),
                 capacity: int = 8, trigger=default_trigger,
                 min_new_spans: int = 8, dump_dir=None):
        self.tracer = tracer
        self.bus = bus
        self.metrics = tuple(metrics)
        self.trigger = trigger
        self.min_new_spans = min_new_spans
        self.dump_dir = Path(dump_dir) if dump_dir else None
        #: stored dumps, newest last
        self.dumps: deque = deque(maxlen=capacity)
        #: every trigger ever matched, (t, reason) — never coalesced
        self.marks: list = []
        self._dumped_at = -1        # emitted_total at last stored dump
        self._seq = 0
        tracer.sinks.append(self._on_span)

    # -- trigger path ----------------------------------------------------

    def _on_span(self, rec: dict) -> None:
        reason = self.trigger(rec) if self.trigger else None
        if reason is not None:
            self.record(reason)

    def record(self, reason: str) -> dict:
        """Store a dump for ``reason`` (or coalesce into the previous
        one when the window has barely moved).  Returns the dump the
        reason landed in.

        Coalescing is SAME-KIND only: a preemption cascade is one
        incident and its repeated ``preempt`` marks annotate one
        dump, but a mark of a DIFFERENT kind arriving inside the
        window is a second incident overlapping the first (a drain
        landing mid-cascade, an SLO shed during an eviction — the
        compound faults the crucible composes) and always forces a
        fresh dump, so neither incident's evidence is buried in the
        other's annotation list."""
        self.marks.append({"t": self.tracer.clock(),
                           "reason": reason})
        fresh = self.tracer.emitted_total - self._dumped_at
        if (self.dumps and fresh < self.min_new_spans
                and reason in self.dumps[-1]["reasons"]):
            self.dumps[-1]["reasons"].append(reason)
            return self.dumps[-1]
        d = self.build(reason)
        self._dumped_at = self.tracer.emitted_total
        self._seq += 1
        self.dumps.append(d)
        if self.dump_dir is not None:
            self.dump_dir.mkdir(parents=True, exist_ok=True)
            path = self.dump_dir / (
                f"flightrec-{self._seq:03d}-{reason}.json")
            path.write_text(json.dumps(d, sort_keys=True))
        return d

    # -- dump construction -----------------------------------------------

    def build(self, reason: str) -> dict:
        """One JSON-safe forensic snapshot: the span window, the bus
        journal summary, the metric exposition text, and the trigger
        history.  Pure — stores nothing (``record`` stores)."""
        out = {"reason": reason,
               "t": self.tracer.clock(),
               "reasons": [reason],
               "spans": list(self.tracer.spans),
               "spans_emitted_total": self.tracer.emitted_total,
               "marks": list(self.marks)}
        if self.bus is not None:
            out["bus"] = self.bus.journal_dump()
        if self.metrics:
            out["metrics"] = render_all(*self.metrics).decode()
            # structured quantile snapshot next to the text
            # exposition: registries carrying streaming digests
            # (utils/digest.py) contribute {family: [rows]} so a dump
            # answers "what was p999" without re-parsing exposition
            digests: dict = {}
            for m in self.metrics:
                snap = getattr(m, "digest_snapshot", None)
                if snap is not None:
                    digests.update(snap())
            if digests:
                out["digests"] = digests
        return out

    def debug_payload(self) -> dict:
        """The ``/debugz`` body: a fresh dump plus how many stored
        incident dumps exist — built on demand, never stored."""
        d = self.build("debugz")
        d["stored_dumps"] = len(self.dumps)
        return d


__all__ = ["REASONS", "FlightRecorder", "default_trigger"]
