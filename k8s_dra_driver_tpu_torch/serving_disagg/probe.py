"""Disaggregation probe: TTFT under overload, unified vs split.

The port of ``k8s_dra_driver_tpu/serving_disagg/probe.py``, with the
same output keys.  It records the difference the role split makes,
holding everything else fixed: the same engines, the same paced
open-loop arrivals at a multiple of the pool's self-calibrated
capacity, once through a unified pool (every replica prefills and
decodes, prefix-affinity routing) and once through a disaggregated
pool (the same replica count split prefill/decode behind the fleet
index).

The number that should move is TTFT at high offered load: in the
unified pool a fill waits for a decode slot, so first-token latency
inherits the decode drain's tail; in the split pool the prefill
replicas keep turning arrivals into first tokens regardless of
decode-slot pressure.  Goodput is recorded too and may go either way
at a fixed replica count.

Also recorded: per-migration wall (``kv_migrate_ms``) and bytes, and a
byte-equality check of every uid that finished in both runs.  The
default model and the ``cfg`` / ``params`` / ``device`` arguments are
gateway/probe.py's.
"""

from __future__ import annotations

import time

import numpy as np


def _pct(vals, q):
    if not vals:
        return 0.0
    return float(np.percentile(np.asarray(vals), q))


def disagg_probe(prefill_replicas: int = 1, decode_replicas: int = 2,
                 slots: int = 4, n_requests: int = 24,
                 n_layers: int = 4, d_model: int = 512, heads: int = 8,
                 kv_heads: int = 2, d_ff: int = 2048,
                 prompt_len: int = 24, max_new: int = 12,
                 max_seq: int = 128, shared_prefix: int = 8,
                 prefix_cache: int = 4, level: float = 4.0,
                 slo_x: float = 24.0, seed: int = 0, cfg=None,
                 params=None, device="cuda") -> dict:
    """One overload run through each pool topology (module
    docstring).  ``level`` is the offered-load multiple of the
    unified pool's calibrated capacity; ``slo_x`` scales each
    request's SLO from the calibrated per-request service time."""
    from ..gateway import FleetGateway, ReplicaManager
    from ..gateway.calibrate import calibrate_capacity
    from ..gateway.probe import probe_model
    from ..gateway.router import PrefixAffinityRouter
    from ..models.serving import Request, ServingEngine
    from ..utils.device import resolve_device
    from .pool import DisaggReplicaManager
    from .router import DisaggRouter

    dev = resolve_device(device)
    if cfg is None:
        cfg, params = probe_model(n_layers, d_model, heads, kv_heads,
                                  d_ff, max_seq, dev)
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, cfg.vocab, shared_prefix) \
        if shared_prefix else None
    tail_lengths = [max(prompt_len - (shared_prefix or 0), 4) // d
                    for d in (1, 2)]

    def one_prompt(i):
        part = rng.integers(0, cfg.vocab,
                            tail_lengths[i % len(tail_lengths)])
        return (part if pre is None
                else np.concatenate([pre, part])).astype(np.int32)

    reqs = [Request(uid=f"q{i}", prompt=one_prompt(i),
                    max_new=max_new) for i in range(n_requests)]
    total = prefill_replicas + decode_replicas

    def engine(name):
        return ServingEngine(params, cfg, slots=slots, max_seq=max_seq,
                             prefix_cache=prefix_cache, device=dev)

    def unified():
        mgr = ReplicaManager(engine, replicas=total,
                             depth_bound=slots)
        return mgr, FleetGateway(mgr, router=PrefixAffinityRouter(),
                                 queue_capacity=4 * n_requests)

    def disagg():
        mgr = DisaggReplicaManager(
            engine, prefill_replicas=prefill_replicas,
            decode_replicas=decode_replicas, depth_bound=slots)
        return mgr, FleetGateway(mgr,
                                 router=DisaggRouter(mgr.index),
                                 queue_capacity=4 * n_requests)

    # -- warmup + calibration (gateway/calibrate.py): the first drain
    # pays the one-time costs, the last measures the warm unified drain
    # rate the offered level is set against
    def cal_reqs(tag):
        return [Request(uid=f"{tag}{r.uid}", prompt=r.prompt,
                        max_new=r.max_new) for r in reqs]

    cap = calibrate_capacity(lambda: unified()[1], cal_reqs)
    base_rps = cap.base_rps
    slo_s = cap.slo_s(slo_x)
    # the split pool's one-time costs (export and adopt paths) outside
    # the measured run too
    _, gw = disagg()
    for req in reqs:
        gw.submit(req)
    gw.run_until_idle()

    def run(make_pool):
        mgr, gw = make_pool()
        interval = 1.0 / (level * base_rps)
        t0 = time.perf_counter()
        sched = [t0 + i * interval for i in range(n_requests)]
        i = 0
        while i < n_requests or len(gw.queue) or any(
                r.in_flight for r in gw.manager.replicas):
            now = time.perf_counter()
            while i < n_requests and now >= sched[i]:
                gw.submit(reqs[i], slo_s=slo_s)
                i += 1
            gw.step()
            if i < n_requests and not len(gw.queue) and not any(
                    r.in_flight for r in gw.manager.replicas):
                time.sleep(max(0.0, sched[i] - time.perf_counter()))
        wall = time.perf_counter() - t0
        recs = list(gw.outcomes.values())
        ttfts = [(g.first_token_s - g.arrival_s) * 1000
                 for g in recs if g.first_token_s is not None]
        waits = [(g.dispatched_s - g.arrival_s) * 1000
                 for g in recs if g.dispatched_s is not None]
        finished = [g for g in recs if g.status == "finished"]
        attained = [g for g in finished
                    if g.finished_s <= g.deadline_s]
        return mgr, gw, {
            "finished": len(finished),
            "shed": sum(1 for g in recs
                        if g.status == "shed_expired"),
            "rejected": len(gw.refused),
            "goodput_rps": round(len(attained) / wall, 2),
            "ttft_p50_ms": round(_pct(ttfts, 50), 2),
            "ttft_p99_ms": round(_pct(ttfts, 99), 2),
            "p99_queue_wait_ms": round(_pct(waits, 99), 2),
            "accounted": len(gw.outcomes) + len(gw.refused)
            == n_requests,
        }

    _, gw_uni, uni = run(unified)
    mgr_dis, gw_dis, dis = run(disagg)

    # routing topology is scheduling, never math: every uid finished
    # under BOTH topologies must carry identical tokens
    both = set(gw_uni.results) & set(gw_dis.results)
    byte_equal = all(
        np.array_equal(gw_uni.results[u].tokens,
                       gw_dis.results[u].tokens) for u in both)

    # per-event samples drained into the gateway registry during the
    # run; the migrator's lifetime ledger keeps the mean recoverable
    mig = mgr_dis.migration_stats()
    kv_migrate_ms = round(
        mig["wall_s"] / mig["migrations"] * 1000, 3) \
        if mig["migrations"] else -1.0

    return {
        "replicas_unified": total,
        "prefill_replicas": prefill_replicas,
        "decode_replicas": decode_replicas,
        "slots": slots,
        "requests": n_requests,
        "offered_x": level,
        "base_rps": round(base_rps, 2),
        "slo_ms": round(slo_s * 1000, 1),
        "unified": uni,
        "disagg": dis,
        "ttft_p99_ms": dis["ttft_p99_ms"],
        "ttft_p99_unified_ms": uni["ttft_p99_ms"],
        "ttft_win_x": round(uni["ttft_p99_ms"]
                            / max(dis["ttft_p99_ms"], 1e-6), 2),
        "p99_wait_win_x": round(
            uni["p99_queue_wait_ms"]
            / max(dis["p99_queue_wait_ms"], 1e-6), 2),
        "kv_migrations": mig["migrations"],
        "kv_bytes_moved": mig["bytes_moved"],
        "kv_migrate_ms": kv_migrate_ms,
        "byte_equal": byte_equal,
        "valid": (uni["accounted"] and dis["accounted"]
                  and byte_equal and mig["migrations"] > 0
                  and dis["ttft_p99_ms"] > 0),
        "note": ("same engines, same paced arrivals at offered_x of "
                 "the unified pool's calibrated capacity; disagg = "
                 "prefill/decode split behind the fleet prefix "
                 "index, KV handoff by copy-on-transfer; "
                 "ttft_win_x > 1 means the split cut p99 TTFT"),
    }


__all__ = ["disagg_probe"]
