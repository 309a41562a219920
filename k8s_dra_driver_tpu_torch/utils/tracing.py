"""Causal span layer: one trace per request.

The port's copy of ``k8s_dra_driver_tpu/utils/tracing.py``: the span
recorder and its pool wiring (``Tracer``, ``wire_pool``), the
per-request critical path, the Chrome-trace exporter and the gang
supervisor's hook (``attach_supervisor``, parallel/supervisor.py).
A **span** is a plain dict
``{trace, span, parent, name, t0, t1, track, tenant?, attrs?}``
recording one arc of a request's life (admission, dispatch, prefill,
migrate, decode, terminal).

- ``emit`` takes the times; it never reads the clock.  Callers already
  hold ``now`` from the pump step, so tracing adds dict construction
  and two appends.
- Spans are not published to the bus one by one: ``flush()``, called
  once per pump step right before ``bus.pump()``, publishes the step's
  batch as ONE ``"spans"`` event.
- The ring (``spans``, a bounded deque) keeps the newest spans;
  ``sinks`` are synchronous taps.

Span identity: ``trace`` is ``t-<request uid>`` (or ``gw-<name>`` for
the gateway's own track); ``span`` ids are tracer-global and monotone;
``parent`` is the previous span emitted on the same
:class:`TraceContext`, so each trace is a causal chain.
"""

from __future__ import annotations

import itertools
import json
import time
from collections import deque
from dataclasses import dataclass


@dataclass(slots=True)
class TraceContext:
    """The per-request (or per-component) causal cursor, carried on
    ``GatewayRequest.trace`` and across drain → requeue → re-dispatch
    so a victim CONTINUES its trace instead of starting a new one.
    ``drained_s`` timestamps the last drain-requeue, giving the
    re-dispatch span its honest t0 (the drain gap is real latency the
    queue-wait histogram alone cannot attribute)."""

    trace_id: str
    tenant: str | None = None
    last_span: int = 0
    drained_s: float | None = None
    #: queue depth observed at admission — carried here instead of an
    #: admission span (admission is the control plane's hottest path);
    #: the dispatch span (t0 = arrival) reports it as its ``depth`` attr
    admit_depth: int = 0


class Tracer:
    """Bounded span recorder with batched bus emission.

    ``bus`` is an optional :class:`~..cluster.bus.EventBus`; when set,
    ``flush()`` publishes each step's spans as one ``"spans"`` event.
    ``clock`` is injected (a fake clock in tests, monotonic live); the
    disaggregated pool reads it around prefill and migration, the
    gateway's hot path never does.
    """

    def __init__(self, bus=None, clock=time.monotonic,
                 capacity: int = 4096):
        self.bus = bus
        self.clock = clock
        #: bounded ring of span dicts, the newest ``capacity`` spans
        self.spans: deque = deque(maxlen=capacity)
        #: synchronous taps called per span
        self.sinks: list = []
        self.emitted_total = 0
        self._pending: list = []
        self._ids = itertools.count(1)
        # bound method cached: emit runs about 3x per request
        self._ring_append = self.spans.append

    def begin(self, key, tenant: str | None = None) -> TraceContext:
        """New trace rooted at ``key`` (a request uid or a component
        name).  Cheap enough to call per admission."""
        return TraceContext(trace_id=f"t-{key}", tenant=tenant)

    def emit(self, ctx: TraceContext, name: str, t0: float,
             t1: float | None = None, track: str = "",
             **attrs) -> dict:
        """Record one span on ``ctx``.  ``t1=None`` marks an instant
        event (zero duration).  ``track`` groups spans into exporter
        rows (replica name, "gateway"); attrs must
        be JSON-safe scalars — they go straight into dumps."""
        sid = next(self._ids)
        rec = {"trace": ctx.trace_id, "span": sid,
               "parent": ctx.last_span, "name": name,
               "t0": t0, "t1": t0 if t1 is None else t1,
               "track": track}
        if ctx.tenant is not None:
            rec["tenant"] = ctx.tenant
        if attrs:
            rec["attrs"] = attrs
        ctx.last_span = sid
        self._ring_append(rec)
        self.emitted_total += 1
        if self.bus is not None:
            self._pending.append(rec)
        if self.sinks:
            for sink in self.sinks:
                try:
                    sink(rec)
                except Exception:
                    pass    # a broken tap must not fail the pump
        return rec

    def flush(self) -> int:
        """Publish the step's span batch as ONE bus event (topic
        ``"spans"``).  Returns the batch size.  Called once per pump
        step so bus seq numbers — and therefore replay — stay
        deterministic under the bus's seeded shuffle."""
        if self.bus is None or not self._pending:
            return 0
        batch, self._pending = self._pending, []
        self.bus.publish("spans", n=len(batch), spans=batch)
        return len(batch)


# -- wiring helpers ------------------------------------------------------

def attach_supervisor(tracer: Tracer, supervisor,
                      name: str = "gang") -> TraceContext:
    """Turn gang state transitions into ``"gang"`` spans via the
    supervisor's ``listeners`` hook (parallel/supervisor.py
    ``_transition``).  Each span covers the time SPENT in the previous
    state, with attrs ``{from, to, dp, step, generation}`` — so a
    RUNNING→SUSPECT→EVICT→REFORM→RESUME arc reads as contiguous spans
    on the "supervisor" track."""
    ctx = tracer.begin(name)
    hold = {"state": supervisor.state, "t": tracer.clock()}

    def listener(state, info):
        now = tracer.clock()
        tracer.emit(ctx, "gang", hold["t"], now, track="supervisor",
                    **{"from": info.get("from", hold["state"]),
                       "to": state,
                       "dp": info.get("dp"),
                       "step": info.get("step"),
                       "generation": info.get("generation")})
        hold["state"], hold["t"] = state, now

    supervisor.listeners.append(listener)
    return ctx


def wire_pool(tracer: Tracer, manager) -> None:
    """Hand the tracer to a ReplicaManager and every replica it will
    ever spawn (initial pool, replacements, scale-ups) — how
    serving_disagg/pool.py emits prefill/migrate spans without the
    gateway walking the pool each step."""
    manager.tracer = tracer
    for r in manager.replicas:
        r.tracer = tracer
    manager.spawn_listeners.append(
        lambda replica: setattr(replica, "tracer", tracer))


# -- analysis ------------------------------------------------------------

def critical_path(spans, trace_id: str) -> dict:
    """Per-request latency breakdown from one trace's spans — where
    the TTFT went.  Cross-checkable against GatewayMetrics histograms
    (queue_wait ↔ ``tpu_gateway_queue_wait_seconds``, decode ↔ the
    TTFT/latency pair); the cross-check test pins that the two
    accountings agree on the same run."""
    recs = [r for r in spans if r["trace"] == trace_id]
    out = {"queue_wait": 0.0, "route": 0.0, "prefill": 0.0,
           "migrate": 0.0, "decode": 0.0, "decode_per_token": 0.0,
           "drain_gap": 0.0, "total": 0.0, "spans": len(recs)}
    if not recs:
        return out
    for r in recs:
        dur = r["t1"] - r["t0"]
        a = r.get("attrs", {})
        if r["name"] == "dispatch":
            out["queue_wait"] += dur
            out["route"] += a.get("route_s", 0.0) or 0.0
        elif r["name"] == "drain_gap":
            out["drain_gap"] += dur
            out["route"] += a.get("route_s", 0.0) or 0.0
        elif r["name"] in ("prefill", "migrate"):
            out[r["name"]] += dur
        elif r["name"] == "terminal":
            out["decode"] += dur
            tokens = a.get("tokens") or 0
            if tokens:
                out["decode_per_token"] = dur / tokens
    out["total"] = (max(r["t1"] for r in recs)
                    - min(r["t0"] for r in recs))
    return out


# -- Chrome-trace-event (Perfetto) exporter ------------------------------

def chrome_trace(spans) -> dict:
    """Spans → Chrome trace-event JSON (the ``traceEvents`` array
    format Perfetto and chrome://tracing load).  Complete 'X' events,
    µs timebase; one tid per track (replica / supervisor /
    reconciler / gateway), discovered in span order so the mapping is
    deterministic.  Load it beside a ``torch.profiler`` trace of the
    same run and the control-plane spans line up with the kernel
    launches they caused."""
    tracks: dict[str, int] = {}
    events = []
    for rec in spans:
        track = rec.get("track") or rec["trace"]
        tid = tracks.setdefault(track, len(tracks) + 1)
        args = {"trace": rec["trace"], "span": rec["span"],
                "parent": rec["parent"]}
        if "tenant" in rec:
            args["tenant"] = rec["tenant"]
        args.update(rec.get("attrs", {}))
        events.append({"ph": "X", "name": rec["name"], "pid": 1,
                       "tid": tid,
                       "ts": round(rec["t0"] * 1e6, 3),
                       "dur": round(
                           max(rec["t1"] - rec["t0"], 0.0) * 1e6, 3),
                       "args": args})
    meta = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
             "args": {"name": track}}
            for track, tid in tracks.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export_chrome(spans) -> str:
    """Deterministic serialization of :func:`chrome_trace` — sorted
    keys, no whitespace — so same seed ⇒ byte-identical export, and
    the same bytes as the JAX package's exporter for the same spans."""
    return json.dumps(chrome_trace(spans), sort_keys=True,
                      separators=(",", ":"))


__all__ = ["TraceContext", "Tracer", "attach_supervisor", "chrome_trace",
           "critical_path", "export_chrome", "wire_pool"]
