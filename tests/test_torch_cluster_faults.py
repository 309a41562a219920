"""The port's cluster client and fault injection
(k8s_dra_driver_tpu_torch/cluster/client.py, cluster/faults.py) held
to the JAX package's on the same scripts: ``FakeCluster``'s watch
events, conflicts and not-founds; ``FaultyClusterClient`` and
``FaultPlan.raise_for`` for every error kind; ``ScriptedChipHealth``
over a kill, latch and heal; and ``corrupt_file`` byte for byte.
Plans come from one JSON text, loaded by both packages."""

import dataclasses
import json

import numpy as np
import pytest

from k8s_dra_driver_tpu.cluster import client as jclient
from k8s_dra_driver_tpu.cluster import faults as jfaults
from k8s_dra_driver_tpu_torch.cluster import client as tclient
from k8s_dra_driver_tpu_torch.cluster import faults as tfaults

SIDES = {"jax": (jclient, jfaults), "torch": (tclient, tfaults)}


@dataclasses.dataclass
class Meta:
    name: str
    namespace: str = "default"
    labels: dict = dataclasses.field(default_factory=dict)
    resource_version: int = 0


@dataclasses.dataclass
class Widget:
    metadata: Meta
    spec: int = 0


def widget(name, ns="default", spec=0, **labels):
    return Widget(Meta(name, ns, dict(labels)), spec)


def outcome(fn):
    """A call's result as comparable data: the value, or the raised
    exception's type name, text and (for API errors) status and
    Retry-After."""
    try:
        v = fn()
    except Exception as e:            # compared across the packages
        return ("raise", type(e).__name__, str(e),
                getattr(e, "status", None), getattr(e, "retry_after_s", None))
    if isinstance(v, list):
        return ("ok", [(o.metadata.namespace, o.metadata.name,
                        o.metadata.resource_version) for o in v])
    if isinstance(v, Widget):
        return ("ok", v.metadata.name, v.metadata.resource_version, v.spec)
    return ("ok", v)


def test_constants_match_the_reference():
    for name in ("VERBS", "ERROR_KINDS", "GANG_VERB", "GANG_WORKER_KIND",
                 "HEALTH_VERB", "CHIP_KIND", "HEAL", "PUMP_VERB",
                 "PUMP_KIND", "CRASH_EXIT_CODE", "CORRUPT_BITFLIP",
                 "CORRUPT_TRUNCATE", "CORRUPT_KINDS", "FAULT_PLAN_ENV",
                 "CRASH_CHECKPOINT_TMP_WRITTEN", "CRASH_CHECKPOINT_ROTATED",
                 "CRASH_CHECKPOINT_SAVED", "CRASH_RESHARD_SHARDS_WRITTEN",
                 "CRASH_RESHARD_COMMITTED", "CRASH_TRAIN_CKPT_SAVING",
                 "CRASH_TRAIN_CKPT_COMMITTED", "CRASH_OUTCOME_APPENDED",
                 "CRASH_OUTCOME_COMMITTED"):
        assert getattr(tfaults, name) == getattr(jfaults, name), name
    for name in ("EVENT_ADDED", "EVENT_MODIFIED", "EVENT_DELETED"):
        assert getattr(tclient, name) == getattr(jclient, name), name


def fake_cluster_script(client_mod):
    fc = client_mod.FakeCluster()
    events = []
    fc.create(widget("b", app="x"))
    fc.create(widget("a", app="y"))
    fc.create(widget("a", ns="other", app="x"))
    unsub = fc.watch("Widget", lambda ev, o: events.append(
        (ev, o.metadata.namespace, o.metadata.name,
         o.metadata.resource_version)))
    out = [
        outcome(lambda: fc.create(widget("a"))),
        outcome(lambda: fc.update(widget("a", spec=5))),
        outcome(lambda: fc.update(widget("zz"))),
        outcome(lambda: fc.get("Widget", "default", "a")),
        outcome(lambda: fc.get("Widget", "default", "zz")),
        outcome(lambda: fc.get("Gadget", "default", "a")),
        outcome(lambda: fc.apply(widget("c", app="x"))),
        outcome(lambda: fc.apply(widget("c", spec=9))),
        outcome(lambda: fc.list("Widget")),
        outcome(lambda: fc.list("Widget", namespace="default")),
        outcome(lambda: fc.list("Widget", label_selector={"app": "x"})),
        outcome(lambda: fc.list("Widget", label_selector={"app": "*"})),
        outcome(lambda: fc.list("Widget", label_selector={"tier": "*"})),
        outcome(lambda: fc.delete("Widget", "default", "b")),
        outcome(lambda: fc.delete("Widget", "default", "b")),
    ]
    unsub()
    unsub()                          # idempotent
    fc.create(widget("d"))            # after unsubscribe: unseen
    return out, events


def test_fake_cluster_matches_reference():
    j = fake_cluster_script(jclient)
    t = fake_cluster_script(tclient)
    assert t == j
    out, events = t
    # watchers see pre-existing objects first, in key order, then live
    assert [e[0] for e in events[:3]] == ["ADDED"] * 3
    assert [(e[1], e[2]) for e in events[:3]] == [
        ("default", "a"), ("default", "b"), ("other", "a")]
    assert out[0][1] == "ConflictError" and out[2][1] == "NotFoundError"
    assert tclient.match_labels({"a": "xy"}, {"a": "x*"})
    assert not tclient.match_labels({}, {"a": "*"})


def plan_json(kind: str) -> str:
    return json.dumps({"seed": 5, "rules": [
        {"verb": "create", "kind": "Widget", "name": "x*", "skip": 1,
         "times": 2, "error": kind, "retry_after_s": 0.25,
         "latency_s": 0.01},
        {"verb": "list", "kind": "*", "name": "*", "probability": 0.5,
         "times": -1, "error": kind},
        {"verb": "get", "kind": "Widget", "name": "y", "error": kind,
         "latency_s": 0.5},
    ]})


class Crashed(Exception):
    pass


def faulty_script(side, kind, monkeypatch):
    client_mod, faults_mod = SIDES[side]

    def fake_exit(code):
        raise Crashed(f"exit {code}")

    monkeypatch.setattr(faults_mod.os, "_exit", fake_exit)
    plan = faults_mod.FaultPlan.from_json(plan_json(kind))
    sleeps = []
    fc = faults_mod.FaultyClusterClient(client_mod.FakeCluster(), plan,
                                        sleep=sleeps.append)
    out = []
    for i in range(4):
        out.append(outcome(lambda: fc.create(widget(f"x{i}"))))
    out.append(outcome(lambda: fc.apply(widget("x9", spec=2))))
    for _ in range(6):
        out.append(outcome(lambda: fc.list("Widget")))
    out.append(outcome(lambda: fc.get("Widget", "default", "y")))
    out.append(outcome(lambda: fc.get("Widget", "default", "x0")))
    out.append(outcome(lambda: fc.update(widget("x0", spec=3))))
    out.append(outcome(lambda: fc.delete("Widget", "default", "x0")))
    out.append(outcome(lambda: fc.watch("Widget", lambda e, o: None)))
    # raise_for straight on a decision of every kind
    direct = outcome(lambda: plan.raise_for(
        faults_mod.Decision(error=kind, retry_after_s=1.5), "ctx"))
    return out, sleeps, list(plan.log), plan.to_json(), direct


@pytest.mark.parametrize("kind", jfaults.ERROR_KINDS)
def test_faulty_client_and_raise_for_match_reference(kind, monkeypatch):
    j = faulty_script("jax", kind, monkeypatch)
    t = faulty_script("torch", kind, monkeypatch)
    # outcomes carry the watch's unsubscribe function: compare its kind
    norm = [o if not callable(o[-1]) else (o[0], "callable")
            for o in t[0]]
    jnorm = [o if not callable(o[-1]) else (o[0], "callable")
             for o in j[0]]
    assert norm == jnorm
    assert t[1:] == j[1:]
    if kind in ("", "hang", "heal"):
        assert t[4] == ("ok", None)
    else:
        assert t[4][0] == "raise"


def test_faulty_client_closes_its_backend():
    closed = []

    class Backend(tclient.FakeCluster):
        def close(self):
            closed.append(True)

    tfaults.FaultyClusterClient(Backend(), tfaults.FaultPlan()).close()
    tfaults.FaultyClusterClient(tclient.FakeCluster(),
                                tfaults.FaultPlan()).close()
    assert closed == [True]


HEALTH_PLAN = json.dumps({"seed": 9, "rules": [
    {"verb": "health", "kind": "Chip", "name": "1", "skip": 2,
     "times": 1, "error": "drop"},
    {"verb": "health", "kind": "Chip", "name": "1", "skip": 6,
     "times": 1, "error": "heal"},
    {"verb": "health", "kind": "Chip", "name": "3", "skip": 4,
     "times": 1, "error": "500"},
    {"verb": "health", "kind": "Chip", "name": "[25]", "probability": 0.3,
     "times": -1, "error": "crash"},
    {"verb": "health", "kind": "Chip", "name": "2", "skip": 8,
     "times": -1, "error": "heal"},
]})


def health_script(faults_mod, armed_heal_at=5):
    plan = faults_mod.FaultPlan.from_json(HEALTH_PLAN)
    src = faults_mod.ScriptedChipHealth(plan, chips=range(6),
                                        base=lambda: {4: "base down"})
    seq = []
    for poll in range(12):
        if poll == armed_heal_at:
            plan.arm(faults_mod.FaultRule(
                verb="health", kind="Chip", name="3", times=1,
                error="heal"))
        seq.append(sorted(src().items()))
    return seq, list(plan.log)


def test_scripted_chip_health_matches_reference():
    j = health_script(jfaults)
    t = health_script(tfaults)
    assert t == j
    seq, _ = t
    # chip 1 latches down from its third poll until the heal
    down1 = [1 in dict(s) for s in seq]
    assert down1[:2] == [False, False] and down1[2] and not down1[-1]
    assert all(dict(s).get(4) == "base down" for s in seq)


@pytest.mark.parametrize("kind", jfaults.CORRUPT_KINDS)
@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("size", [1, 5, 4096, 10007])
def test_corrupt_file_is_byte_identical(tmp_path, kind, seed, size):
    data = np.random.default_rng(size + seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    out = {}
    for side, (_, faults_mod) in SIDES.items():
        p = tmp_path / side / "shard.bin"
        p.parent.mkdir()
        p.write_bytes(data)
        desc = faults_mod.corrupt_file(p, kind, seed=seed)
        out[side] = (desc, p.read_bytes())
    assert out["torch"] == out["jax"]
    if size > 1 or kind == tfaults.CORRUPT_BITFLIP:
        assert out["torch"][1] != data


def test_corrupt_file_refusals(tmp_path):
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    for faults_mod in (jfaults, tfaults):
        with pytest.raises(ValueError, match="empty"):
            faults_mod.corrupt_file(empty, tfaults.CORRUPT_BITFLIP)
    full = tmp_path / "full.bin"
    full.write_bytes(b"abc")
    msgs = []
    for faults_mod in (jfaults, tfaults):
        with pytest.raises(ValueError) as e:
            faults_mod.corrupt_file(full, "shred")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
