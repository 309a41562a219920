"""The port's fleet invariants and flight recorder
(k8s_dra_driver_tpu_torch/cluster/invariants.py, cluster/flightrec.py)
held to the JAX package's on the same inputs.

Every checker runs on a clean and a violating input built from plain
stand-in objects (the checkers are duck-typed), and the two packages'
violation lists must be equal string for string.  The flight recorders
of both packages watch the same span stream and must agree on their
reasons, coalescing, file names and dump JSON; the metrics text differs
only in the ``_created`` samples the port does not write (ROADMAP
Queue C item 14)."""

import json
import types

import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.cluster import bus as jbus
from k8s_dra_driver_tpu.cluster import flightrec as jfr
from k8s_dra_driver_tpu.cluster import invariants as jinv
from k8s_dra_driver_tpu.fleet import supply as jsupply
from k8s_dra_driver_tpu.utils import metrics as jmetrics
from k8s_dra_driver_tpu.utils import tracing as jtracing
from k8s_dra_driver_tpu_torch.cluster import bus as tbus
from k8s_dra_driver_tpu_torch.cluster import flightrec as tfr
from k8s_dra_driver_tpu_torch.cluster import invariants as tinv
from k8s_dra_driver_tpu_torch.fleet import supply as tsupply
from k8s_dra_driver_tpu_torch.utils import metrics as tmetrics
from k8s_dra_driver_tpu_torch.utils import tracing as ttracing

NS = types.SimpleNamespace


def test_constants_match_the_reference():
    assert tinv.TERMINAL_STATUSES == jinv.TERMINAL_STATUSES
    assert tinv.RECLAIM_KINDS == jinv.RECLAIM_KINDS
    assert tfr.REASONS == jfr.REASONS
    assert sorted(tinv.__all__) == sorted(jinv.__all__)


# -- stand-ins ------------------------------------------------------------

class Queue:
    def __init__(self, uids):
        self._uids = list(uids)

    def uids(self):
        return list(self._uids)


def gateway(*, admitted, outcomes, refused=(), queues=((),),
            in_flight=None, sharded=True):
    """A gateway stand-in: ``outcomes`` uid -> status, ``refused`` uids,
    one admission queue per pump, ``in_flight`` replica -> uids."""
    replicas = [NS(name=n, in_flight={u: object() for u in uids})
                for n, uids in (in_flight or {}).items()]
    qs = [Queue(q) for q in queues]
    gw = NS(admissions_total=admitted,
            outcomes={u: NS(status=s, uid=u) for u, s in outcomes.items()},
            refused=[NS(uid=u) for u in refused],
            manager=NS(replicas=replicas))
    gw.pending = lambda: sum(len(q.uids()) for q in qs)
    if sharded:
        gw.pumps = [NS(queue=q) for q in qs]
    else:
        gw.queue = qs[0]
    return gw


GATEWAYS = {
    "clean": dict(admitted=5, outcomes={"a": "finished",
                                        "b": "shed_expired"},
                  refused=["c"], queues=(["d"], []),
                  in_flight={"d1": ["e"]}),
    "leak": dict(admitted=7, outcomes={"a": "finished", "b": "running"},
                 refused=["a", "c", "c"], queues=(["a"], ["e"]),
                 in_flight={"d1": ["e"], "p0": ["b"]}),
    "unsharded": dict(admitted=3, outcomes={"a": "finished"},
                      queues=(["a", "b"],), in_flight={"d1": ["b"]},
                      sharded=False),
}


@pytest.mark.parametrize("case", sorted(GATEWAYS))
def test_gateway_checkers_match_reference(case):
    gw = gateway(**GATEWAYS[case])
    for fn in ("gateway_conservation", "terminal_is_final"):
        want = getattr(jinv, fn)(gw)
        assert getattr(tinv, fn)(gw) == want, fn
    assert (tinv.gateway_conservation(gw, submitted=4)
            == jinv.gateway_conservation(gw, submitted=4))
    uids = ["a", "b", "c", "d", "e", "zz"]
    want = jinv.exactly_once_terminal(gw, uids)
    assert tinv.exactly_once_terminal(gw, uids) == want
    if case == "clean":
        assert tinv.gateway_conservation(gw) == []
        assert tinv.terminal_is_final(gw) == []
    else:
        assert want


def test_byte_equal_matches_reference():
    rng = np.random.default_rng(3)
    toks = {f"u{i}": rng.integers(0, 64, 7).astype(np.int32)
            for i in range(4)}
    results = {u: NS(tokens=t) for u, t in toks.items()}
    clean = {u: t.copy() for u, t in toks.items()}
    assert tinv.byte_equal(results, clean) == [] == \
        jinv.byte_equal(results, clean)
    bad = dict(clean)
    bad["u1"] = bad["u1"].copy()
    bad["u1"][3] += 1
    bad["u2"] = bad["u2"][:5]
    bad["missing"] = np.zeros(7, np.int32)
    want = jinv.byte_equal(results, bad)
    assert len(want) == 3
    assert tinv.byte_equal(results, bad) == want
    # the port takes tensors and lists on either side, exactly
    tres = {u: NS(tokens=torch.as_tensor(t)) for u, t in toks.items()}
    assert tinv.byte_equal(tres, {u: t.tolist() for u, t in bad.items()}) \
        == want
    assert tinv.byte_equal(results, {u: torch.as_tensor(t)
                                     for u, t in bad.items()}) == want


def rec(cause, restored_step, steps_lost=0):
    return NS(cause=cause, restored_step=restored_step,
              steps_lost=steps_lost)


LOSSES = {
    "contiguous": ([(s, 1.0 / s) for s in range(1, 7)], []),
    "declared rewind": ([(1, 1.0), (2, 0.9), (3, 0.8), (3, 0.8),
                         (4, 0.7)], [rec("dead", 2)]),
    "double restore": ([(1, 1.0), (2, 0.9), (3, 0.8), (3, 0.8), (3, 0.8),
                        (4, 0.7)], [rec("dead", 2), rec("hang", 2)]),
    "undeclared": ([(1, 1.0), (2, 0.9), (4, 0.8), (2, 0.7),
                    (3, float("nan"))], [rec("dead", 0)]),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_losses_exactly_once_matches_reference(case):
    losses, recs = LOSSES[case]
    want = jinv.losses_exactly_once(losses, recs)
    assert tinv.losses_exactly_once(losses, recs) == want
    assert bool(want) == (case == "undeclared")


def supervisor(*, recoveries=(), dead=(), excluded=(), workers=()):
    return NS(recoveries=list(recoveries), _dead_chips=set(dead),
              _placement_excluded=set(excluded),
              workers=[NS(name=n, chips=tuple(c), alive=a)
                       for n, c, a in workers],
              losses=[], state="running")


def test_gang_checkers_match_reference():
    sup = supervisor(
        recoveries=[rec("dead", 4), rec("health", 6), rec("hang", 4)],
        dead=[2], excluded=[5, 6],
        workers=[("g1w0", (0,), True), ("g1w1", (2,), True),
                 ("g1w2", (5, 6), True), ("g1w3", (2,), False)])
    for tainted in ({4: 1}, {4: 0, 6: 3}, {6: 1}, [4, 8], {}):
        want = jinv.untainted_restores(sup, tainted, gang="mid")
        assert tinv.untainted_restores(sup, tainted, gang="mid") == want
    assert jinv.untainted_restores(sup, {4: 1}, gang="mid")
    assert tinv.untainted_restores(sup, {6: 2}, gang="mid") == []
    want = jinv.placement_fence(sup, gang="lo")
    assert len(want) == 2
    assert tinv.placement_fence(sup, gang="lo") == want
    clean = supervisor(dead=[3], workers=[("g0w0", (0,), True),
                                          ("g0w1", (3,), False)])
    assert tinv.placement_fence(clean) == [] == jinv.placement_fence(clean)


def ledger_case(supply, violating):
    """(ledger, records, specs, events) over one package's owner tags."""
    chips = list(range(6))
    owners = {c: None for c in chips}
    owners[0] = supply.training_tag("lo")
    owners[1] = supply.training_tag("lo")
    owners[2] = supply.serving_tag("hi", "d1")
    owners[3] = supply.training_tag("mid")
    if violating:
        owners[4] = supply.training_tag("lo")
        owners[5] = supply.serving_tag("lo", "x")
    ledger = NS(chips=chips, owners=owners)
    mgr = NS(replicas=[NS(name="d1", state="ready", chip=2),
                       NS(name="p0", state="dead", chip=1),
                       NS(name="p1", state="ready", chip=None)]
             + ([NS(name="d2", state="ready", chip=0),
                 NS(name="d9", state="ready", chip=9)]
                if violating else []))
    lo = supervisor(workers=[("g0w0", (0,), True), ("g0w1", (1,), True),
                             ("g0w2", (2,), violating)])
    mid = supervisor(workers=[("g0w0", (3,), True), ("g0w1", (4,), False)])
    records = [("hi", mgr, None), ("lo", None, lo), ("mid", None, mid)]
    specs = [NS(name="hi", priority=3, quota=6),
             NS(name="mid", priority=2, quota=4),
             NS(name="lo", priority=1, quota=2)]
    events = [(1.0, "grant", {"tenant": "hi"}),
              (2.0, "reclaim_park", {"tenant": "lo",
                                     "beneficiary": "hi"}),
              (3.0, "reclaim_shrink", {"tenant": "mid",
                                       "beneficiary": "hi"})]
    if violating:
        events += [(4.0, "reclaim_drain", {"tenant": "hi",
                                           "beneficiary": "mid"}),
                   (5.0, "reclaim_park", {"tenant": "mid",
                                          "beneficiary": "mid"}),
                   (6.0, "reclaim_shrink", {"tenant": "lo"})]
    return ledger, records, specs, events


@pytest.mark.parametrize("violating", [False, True])
def test_ledger_checkers_and_check_cycle_match_reference(violating):
    j = ledger_case(jsupply, violating)
    t = ledger_case(tsupply, violating)
    assert t[0].owners == j[0].owners
    out = {}
    for side, inv, (ledger, records, specs, events) in (
            ("jax", jinv, j), ("torch", tinv, t)):
        gw = gateway(**GATEWAYS["leak" if violating else "clean"])
        sup = supervisor(recoveries=[rec("dead", 2)], dead=[1],
                         workers=[("g0w0", (1,), violating)])
        sup.losses = [(1, 1.0), (2, 1.0), (3, 1.0), (3, 1.0)] + (
            [(5, 1.0)] if violating else [])
        out[side] = dict(
            conservation=inv.ledger_conservation(ledger, records),
            quota=inv.quota_respected(ledger, specs),
            order=inv.reclaim_priority_order(specs, events),
            cycle=inv.check_cycle(
                gateways=[("hi", gw)], supervisors=[("lo", sup)],
                ledger=ledger, records=records, specs=specs,
                events=events, submitted={"hi": 5},
                tainted={"lo": {2: 0}}),
            bare=inv.check_cycle())
    assert out["torch"] == out["jax"]
    got = out["torch"]
    assert bool(got["conservation"]) == violating
    assert bool(got["quota"]) == violating
    assert bool(got["order"]) == violating
    assert got["bare"] == []
    if violating:
        assert len(got["cycle"]) > 5


# -- the flight recorder --------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def span_stream():
    """(name, attrs) spans: incidents of every reason, same-kind
    repeats inside the coalescing window, and filler between them."""
    out = []
    for i in range(6):
        out.append(("prefill", {"replica": "p0", "n": i}))
    out.append(("drain", {"replica": "d1"}))
    out.append(("drain", {"replica": "d2"}))           # coalesces
    out.append(("terminal", {"status": "shed_expired"}))  # new kind
    out.append(("gang", {"to": "EVICT", "dp": 2}))
    out.append(("gang", {"to": "reform", "dp": 1}))   # not a trigger
    for i in range(9):
        out.append(("decode", {"replica": "d1", "n": i}))
    out.append(("reconcile", {"kind": "reclaim_park"}))
    out.append(("reconcile", {"kind": "reclaim_shrink"}))  # coalesces
    out.append(("reconcile", {"kind": "grant"}))
    out.append(("gang", {"to": "parked"}))
    out.append(("gang", {"to": "FAILED"}))
    out.append(("alert", {"tenant": "hi"}))
    for i in range(10):
        out.append(("terminal", {"status": "finished"}))
    out.append(("drain", {"replica": "d3"}))
    return out


def record_stream(side, dump_dir):
    bus_mod, fr_mod, tr_mod, met_mod = {
        "jax": (jbus, jfr, jtracing, jmetrics),
        "torch": (tbus, tfr, ttracing, tmetrics)}[side]
    clock = Clock()
    bus = bus_mod.EventBus(seed=3)
    tracer = tr_mod.Tracer(bus=bus, clock=clock, capacity=16)
    metrics = met_mod.RecoveryMetrics()
    rec_ = fr_mod.FlightRecorder(tracer, bus=bus, metrics=(metrics,),
                                 capacity=6, min_new_spans=8,
                                 dump_dir=dump_dir)
    ctx = tracer.begin("fleet", tenant="hi")
    for i, (name, attrs) in enumerate(span_stream()):
        clock.t = float(i)
        if name == "gang":
            metrics.observe_recovery(0.25 * (i + 1))
        tracer.emit(ctx, name, clock.t - 0.5, clock.t, track="t",
                    **attrs)
        if i % 5 == 4:
            tracer.flush()
            bus.publish("demand", tenant="hi", depth=i)
            bus.pump()
    rec_.record("failed")
    return rec_, rec_.debug_payload()


def scrub(dump):
    """A dump with the ``_created`` samples taken out of its metrics."""
    d = json.loads(json.dumps(dump, sort_keys=True))
    if "metrics" in d:
        d["metrics"] = "\n".join(
            ln for ln in d["metrics"].splitlines()
            if "_created" not in ln)
    return d


def test_flight_recorder_matches_reference(tmp_path):
    jrec, jdebug = record_stream("jax", tmp_path / "jax")
    trec, tdebug = record_stream("torch", tmp_path / "torch")
    assert trec.marks == jrec.marks
    assert [d["reasons"] for d in trec.dumps] == \
        [d["reasons"] for d in jrec.dumps]
    assert [scrub(d) for d in trec.dumps] == [scrub(d) for d in jrec.dumps]
    assert scrub(tdebug) == scrub(jdebug)
    jfiles = sorted(p.name for p in (tmp_path / "jax").iterdir())
    tfiles = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert tfiles == jfiles
    for name in tfiles:
        assert scrub(json.loads((tmp_path / "torch" / name).read_text())) \
            == scrub(json.loads((tmp_path / "jax" / name).read_text()))
    # what the stream is built to show: every reason, same-kind
    # coalescing, a different kind forcing a fresh dump
    reasons = [m["reason"] for m in trec.marks]
    assert set(tfr.REASONS) <= set(reasons)
    assert any(len(d["reasons"]) > 1 for d in trec.dumps)
    assert len(trec.dumps) == 6                      # capacity
    assert "tpu_train_digest_recovery_seconds" in tdebug["digests"]
    assert tdebug["stored_dumps"] == 6
    # the only difference a dump shows is the _created samples
    jm = jdebug["metrics"].splitlines()
    assert any("_created" in ln for ln in jm)
    assert not any("_created" in ln for ln in tdebug["metrics"].splitlines())


def test_default_trigger_matches_reference():
    recs = [{"name": n, "attrs": a} for n, a in span_stream()] + [
        {"name": "gang"}, {"name": "reconcile", "attrs": {"kind": "PREEMPT"}},
        {"name": "terminal"}, {}]
    assert [tfr.default_trigger(r) for r in recs] == \
        [jfr.default_trigger(r) for r in recs]
