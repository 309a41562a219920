"""Port multi-process gateway (k8s_dra_driver_tpu_torch/gateway/
procpump.py): real pump subprocesses on the CPU (``device="cpu"``).

Null-engine mechanics (tests/test_procgateway.py's scenarios, a few to
a pump pool so the file stays short): pool-wide exactly-once with every
terminal journaled and the digest banks merged across processes, the
duplicate uid refused pool-wide, door spill past a full home pump, a
door refusal at the worker spilled conflict-free, work stealing over
the wire, a thief SIGKILLed mid-steal with its stolen request
re-homed, a scripted pump SIGKILL with every victim requeued on its
unchanged deadline and the dead pump's digests kept, heartbeat-silence
eviction of a SIGSTOPped pump, and a loud failure when the last pump
dies.  A pump asked for the card on a machine without one exits with
the error.  The tiny-engine acceptance (tests/test_chaos_multiproc.py's
shape): 3 pumps of the 2-layer f32 transformer, one SIGKILLed
mid-stream under bursty trace replay, every stream byte-equal to one
port engine on the same seed weights (``tiny_model``); then a KV block
exported by one surviving pump and adopted by another over the wire.
The gateways are held to the JAX package's invariant checkers
(tests/invariants.py).
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu_torch.cluster.faults import (PUMP_KIND, PUMP_VERB,
                                                     FaultPlan, FaultRule)
from k8s_dra_driver_tpu_torch.gateway.admission import QUEUED
from k8s_dra_driver_tpu_torch.gateway.loadgen import load_trace, replay
from k8s_dra_driver_tpu_torch.gateway.procpump import (ProcessGateway,
                                                       PumpDead,
                                                       tiny_model)
from k8s_dra_driver_tpu_torch.gateway.wire import encode_request
from k8s_dra_driver_tpu_torch.models.serving import Request, ServingEngine
from k8s_dra_driver_tpu_torch.serving_disagg.wirekv import frame_bytes

from invariants import (assert_byte_equal, assert_exactly_once,
                        assert_requeue_observed)

pytestmark = pytest.mark.timeout_s(300)

#: the 2-layer transformer of the JAX chaos test, as ``--engine-cfg``
ENGINE_CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
                  d_ff=64, max_seq=48, n_kv_heads=2)


def make_req(uid, seed, n_prompt=6, max_new=4, temperature=0.0):
    return Request(uid=uid, prompt=np.random.default_rng(seed).integers(
        0, 64, n_prompt, dtype=np.int32), max_new=max_new,
        temperature=temperature, seed=seed)


def reqs_for_shard(gw, shard, n, tag="s", start_seed=0, **kw):
    """First ``n`` seeds whose prompts hash into ``shard``."""
    out, seed = [], start_seed
    while len(out) < n:
        req = make_req(f"{tag}{shard}-{seed}", seed, **kw)
        if gw._shard(req.prompt) == shard:
            out.append(req)
        seed += 1
    return out


def pool(tmp_path, **kw):
    kw.setdefault("engine", "null")
    return ProcessGateway(tmp_path, device="cpu", **kw)


def journal_clean(gw, uids):
    view = gw.store.replay()
    assert set(view.terminals) >= set(uids)
    assert view.conflicts == [] and view.corrupt == 0
    assert "rejected_full" not in view.counts()


def test_exactly_once_journaled_and_duplicates_pool_wide(tmp_path):
    """Every terminal reported once and journaled first; digest banks
    merged across the pump processes; a live uid is refused by every
    pump, and reused after its terminal it starts a fresh lifecycle."""
    with pool(tmp_path, workers=2, replicas=2, slots=4) as gw:
        subs = [make_req(f"u{i}", i) for i in range(12)]
        for r in subs:
            assert gw.submit(r, 60.0).status == QUEUED
        gw.run_until_idle()
        assert_exactly_once(gw, subs)
        journal_clean(gw, [r.uid for r in subs])
        assert gw.merged_digests().digests["queue_wait"].count == 12
        # a live uid is refused whichever pump its prompt hashes to
        assert gw.submit(make_req("dup", 1), 60.0).status == QUEUED
        assert gw.submit(make_req("dup", 2), 60.0).status \
            == "rejected_duplicate"
        assert gw.submit(make_req("dup", 3), 60.0).status \
            == "rejected_duplicate"
        gw.run_until_idle()
        assert gw.outcomes["dup"].status == "finished"
        assert gw.submit(make_req("u3", 7), 60.0).status == QUEUED
        gw.run_until_idle()
        assert gw.outcomes["u3"].status == "finished"
        st = gw._rpc(gw.handles[0], "stats")
        assert st["kernel_launches"] == {"flash_fwd": 0, "flash_fwd_tc": 0,
                                         "paged_decode": 0}
        assert st["fsync_count"] >= 1


def test_steal_spill_and_thief_death(tmp_path):
    """On one 2-pump pool, in turn: an idle pump steals queued work over
    the wire; a full home pump spills at the door; a stale depth view
    sends a submit to a full pump, which refuses it at its door, and the
    conductor spills it to the sibling with no conflicting journal
    record; a thief SIGKILLed as it adopts a stolen request leaves that
    request re-homed on the survivor, finished exactly once."""
    with pool(tmp_path, workers=2, replicas=1, slots=1, queue_capacity=4,
              steps_per_request=3) as gw:
        steal = reqs_for_shard(gw, 0, 4, tag="w")
        for r in steal:
            assert gw.submit(r, 600.0).status == QUEUED
        gw.run_until_idle()
        assert gw.steals_total >= 1, "idle pump never stole"
        assert_exactly_once(gw, steal)

        spill = reqs_for_shard(gw, 0, 7, tag="d", start_seed=1000)
        for r in spill[:6]:
            assert gw.submit(r, 600.0).status == QUEUED
        assert {gw._live[r.uid]["worker"] for r in spill[:6]} \
            == {"pump0", "pump1"}, "capacity overflow never spilled"
        gw.handles[0].depth = 0          # the stale view
        assert gw.submit(spill[6], 600.0).status == QUEUED
        assert gw._live[spill[6].uid]["worker"] == "pump1"
        gw.run_until_idle()
        assert_exactly_once(gw, steal + spill)
        journal_clean(gw, [r.uid for r in steal + spill])

        real_rpc, killed = gw._rpc, []

        def rpc(h, op, *a, **kw):
            if op == "adopt" and not killed:
                killed.append(h.name)
                os.kill(h.proc.pid, signal.SIGKILL)
                h.proc.wait(timeout=10)
            return real_rpc(h, op, *a, **kw)

        gw._rpc = rpc
        orphan = reqs_for_shard(gw, 0, 4, tag="o", start_seed=2000)
        for r in orphan:
            assert gw.submit(r, 600.0).status == QUEUED
        gw.run_until_idle()
        assert killed == ["pump1"]
        assert gw.stats()["pump_deaths"] == 1
        assert_exactly_once(gw, steal + spill + orphan)
        assert gw.store.replay().conflicts == []


def test_scripted_kill_requeues_on_unchanged_deadlines(tmp_path):
    """A scripted SIGKILL after two cycles: every victim requeued at a
    survivor with its original deadline, all 24 exactly once, the
    journal conflict-free, and the dead pump's digest samples kept in
    the merge."""
    plan = FaultPlan([FaultRule(verb=PUMP_VERB, kind=PUMP_KIND,
                                name="pump0", skip=2, times=1,
                                error="crash")])
    with pool(tmp_path, workers=3, replicas=2, slots=2,
              steps_per_request=4, pump_plan=plan) as gw:
        subs = [make_req(f"u{i}", i) for i in range(24)]
        deadlines = {}
        for r in subs:
            g = gw.submit(r, 600.0)
            assert g.status == QUEUED
            deadlines[r.uid] = g.deadline_s
        gw.step()
        gw.step()
        before = gw.merged_digests().digests["queue_wait"].count
        assert before > 0
        gw.run_until_idle()
        st = gw.stats()
        assert st["pump_deaths"] == 1 and st["pumps_live"] == 2
        assert_exactly_once(gw, subs)
        for g in assert_requeue_observed(gw):
            assert g.deadline_s == deadlines[g.request.uid]
        assert gw.store.replay().conflicts == []
        assert "pump0" in gw._dead_banks
        assert gw.merged_digests().digests["queue_wait"].count >= before
        assert any(t == "pump_kill" for t in gw.bus.journal_topics())


def test_heartbeat_silence_evicts_and_last_death_is_loud(tmp_path):
    """A SIGSTOPped pump (alive, silent) is evicted past the watchdog
    into the same drain, and its work finishes on the survivor; when
    the last pump dies with work pending the conductor raises."""
    with pool(tmp_path, workers=2, replicas=1, slots=1, queue_capacity=32,
              steps_per_request=3, heartbeat_s=0.1, watchdog_s=1.0,
              rpc_timeout_s=5.0) as gw:
        subs = [make_req(f"u{i}", i) for i in range(8)]
        for r in subs:
            assert gw.submit(r, 600.0).status == QUEUED
        frozen = gw.handles[0]
        os.kill(frozen.proc.pid, signal.SIGSTOP)
        time.sleep(1.5)
        gw.run_until_idle()
        assert not frozen.live
        assert gw.stats()["pump_deaths"] >= 1
        assert_exactly_once(gw, subs)
        with pytest.raises(PumpDead):
            gw._rpc(frozen, "step", rounds=1)
        gw.submit(make_req("late", 50, max_new=4), 600.0)
        last = gw.handles[1]
        os.kill(last.proc.pid, signal.SIGKILL)
        last.proc.wait(timeout=10)
        with pytest.raises(RuntimeError, match="no live pump"):
            gw.run_until_idle()


def test_card_pump_without_a_card_exits_with_the_error(tmp_path):
    """``device="cuda"`` on a machine without a card: the pump dies with
    the device error instead of serving from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("holds the no-card refusal; a card is present")
    with pytest.raises(PumpDead, match="CUDA is not available"):
        ProcessGateway(tmp_path, workers=1, engine="null", device="cuda")


def test_tiny_pool_sigkill_byte_equal_and_kv_over_the_wire(tmp_path):
    """THE acceptance on real engines: pump0 SIGKILLed mid-stream under
    bursty trace replay, the two surviving pumps absorb the drain, every
    request finishes exactly once byte-equal to one port engine on the
    same seed weights (greedy and sampled), deadlines still date from
    arrival, the journal agrees.  Then a KV block exported by one
    survivor crosses the wire and the other survivor, adopting it,
    continues with the oracle's tokens."""
    cfg, params = tiny_model(ENGINE_CFG, "cpu")
    plan = FaultPlan([FaultRule(verb=PUMP_VERB, kind=PUMP_KIND,
                                name="pump0", skip=4, times=1,
                                error="crash")])
    with pool(tmp_path, workers=3, engine="tiny", engine_cfg=ENGINE_CFG,
              replicas=2, slots=2, queue_capacity=64,
              pump_plan=plan) as gw:
        subs = reqs_for_shard(gw, 0, 18, tag="k")
        for i in range(0, 18, 5):
            subs[i].temperature = 0.8
        rep = replay(gw, load_trace("bursty"), offered_x=4.0,
                     base_rps=20.0, make_request=lambda i: subs[i],
                     n_requests=len(subs), slo_s=600.0)
        assert rep["submitted"] == len(subs)
        gw.run_until_idle()
        st = gw.stats()
        assert st["pump_deaths"] == 1 and st["pumps_live"] == 2
        assert_exactly_once(gw, subs)
        eng = ServingEngine(params, cfg, slots=2, device="cpu")
        handoff = make_req("h", 77, n_prompt=9, max_new=6,
                           temperature=0.7)
        for r in subs + [handoff]:
            eng.submit(r)
        oracle = {f.uid: np.asarray(f.tokens) for f in eng.run()}
        assert_byte_equal(gw, subs, oracle)
        for g in assert_requeue_observed(gw):
            assert g.deadline_s == pytest.approx(g.arrival_s + 600.0,
                                                 abs=1e-3)
        view = gw.store.replay()
        assert set(view.terminals) == {r.uid for r in subs}
        assert view.conflicts == [] and view.corrupt == 0

        src, dst = [h for h in gw.handles if h.live]
        exp = gw._rpc(src, "kv_export", req=encode_request(handoff))
        blk = exp["block"]
        assert blk["kind"] == "kv_block" and blk["carry_key"] is not None
        assert blk["k"][0]["dtype"] == "<f4"
        assert frame_bytes(blk) > 2 * cfg.n_layers * cfg.max_seq * \
            cfg.n_kv_heads * cfg.d_head * 4
        got = gw._rpc(dst, "kv_adopt", block=blk)
        np.testing.assert_array_equal(got["tokens"], oracle["h"])
        assert set(exp["ms"]) == {"export", "encode"}
        assert set(got["ms"]) == {"decode", "adopt", "generate"}
