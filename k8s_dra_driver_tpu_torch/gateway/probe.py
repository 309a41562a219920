"""Gateway probe: offered-load sweep -> goodput + queue waits.

The port of ``k8s_dra_driver_tpu/gateway/probe.py``, with the same
output keys.  It measures the layer above one engine: paced arrivals
against a replica pool behind the admission queue, reporting goodput
(SLO-attained completions/s), SLO attainment, and p50/p99
admission-queue wait at offered loads below and above the pool's
measured capacity.  Below capacity the queue should be invisible; above
it the queue fills, waits grow, and the gateway converts the excess
into explicit shed/reject outcomes.

Wall-clock discipline: arrivals and SLOs are real-time, so the probe
calibrates against its own measured drain rate first
(gateway/calibrate.py), making the offered levels machine-relative.

The default model is the reference probe's (vocab 32000, d_model 512, 4
layers, 8 heads of 64 over 2 KV heads, d_ff 2048, bf16) with random
weights from a generator seeded 0 on ``device``; a caller may pass its
own ``cfg`` and ``params`` (the on-card smoke run passes the 154M).
The engines' caches hold ``max_seq`` positions either way.  Prompts come
from a numpy generator seeded ``seed``.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _percentile(vals: list[float], q: float) -> float:
    if not vals:
        return 0.0
    return float(np.percentile(np.asarray(vals), q))


def probe_model(n_layers: int, d_model: int, heads: int, kv_heads: int,
                d_ff: int, max_seq: int, device):
    """(cfg, params) of the reference probe's shape in bf16, random
    weights from a generator seeded 0 on ``device``."""
    from ..models.transformer import TransformerConfig, init_params
    cfg = TransformerConfig(
        vocab=32000, d_model=d_model, n_layers=n_layers, n_heads=heads,
        d_head=d_model // heads, n_kv_heads=kv_heads, d_ff=d_ff,
        max_seq=max_seq, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    return cfg, params


def gateway_probe(replicas: int = 2, slots: int = 4,
                  n_requests: int = 16,
                  n_layers: int = 4, d_model: int = 512,
                  heads: int = 8, kv_heads: int = 2, d_ff: int = 2048,
                  prompt_len: int = 24, max_new: int = 12,
                  max_seq: int = 128,
                  shared_prefix: int = 8, prefix_cache: int = 2,
                  levels: tuple = (0.5, 4.0),
                  slo_x: float = 12.0,
                  queue_capacity: int | None = None,
                  seed: int = 0, cfg=None, params=None,
                  device="cuda") -> dict:
    """Offered-load sweep through a ``replicas``-engine pool.

    ``levels`` are offered-load multiples of the calibrated pool
    capacity; ``slo_x`` sets each request's SLO to ``slo_x`` times the
    calibrated per-request service time, so sub-capacity traffic
    attains it trivially and the overload level sheds.  The top-level
    goodput is the best level's, the waits the HIGHEST level's (the
    stress numbers); per-level detail is in ``levels``."""
    from ..models.serving import Request, ServingEngine
    from ..utils.device import resolve_device
    from .calibrate import calibrate_capacity
    from .frontend import FleetGateway
    from .replica import ReplicaManager
    from .router import PrefixAffinityRouter

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

    def requests(tag, n):
        return [Request(uid=f"{tag}{i}", prompt=one_prompt(i),
                        max_new=max_new) for i in range(n)]

    def pool():
        # depth_bound=slots: dispatch no deeper than the decode batch,
        # so waiting is measured in the ADMISSION queue (the thing the
        # probe reports) instead of hiding in engine-side queues
        return ReplicaManager(
            lambda name: ServingEngine(params, cfg, slots=slots,
                                       max_seq=max_seq,
                                       prefix_cache=prefix_cache,
                                       device=dev),
            replicas=replicas, depth_bound=slots)

    # -- warmup then calibration (the shared helper) --------------------
    cap = calibrate_capacity(
        lambda: FleetGateway(pool(), router=PrefixAffinityRouter(),
                             queue_capacity=queue_capacity
                             or 4 * n_requests),
        lambda tag: requests(tag, n_requests))
    base_rps = cap.base_rps
    slo_s = cap.slo_s(slo_x)

    # -- the sweep -------------------------------------------------------
    out_levels = []
    valid = True
    for li, level in enumerate(levels):
        offered_rps = level * base_rps
        interval = 1.0 / offered_rps
        gw = FleetGateway(pool(), router=PrefixAffinityRouter(),
                          queue_capacity=queue_capacity
                          or max(n_requests // 2, 4))
        reqs = requests(f"l{li}_", n_requests)
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
                time.sleep(max(0.0,
                               sched[i] - time.perf_counter()))
        wall = time.perf_counter() - t0
        st = gw.stats()["outcomes"]
        finished = [g for g in gw.outcomes.values()
                    if g.status == "finished"]
        attained = [g for g in finished
                    if g.finished_s <= g.deadline_s]
        waits_ms = [(g.dispatched_s - g.arrival_s) * 1000
                    for g in finished if g.dispatched_s is not None]
        accounted = (len(gw.outcomes) + len(gw.refused)
                     == n_requests)
        valid = valid and accounted
        out_levels.append({
            "offered_x": level,
            "offered_rps": round(offered_rps, 2),
            "admitted": n_requests - len(gw.refused),
            "finished": st.get("finished", 0),
            "shed": st.get("shed_expired", 0),
            "rejected": len(gw.refused),
            "goodput_rps": round(len(attained) / wall, 2),
            "slo_attainment": round(
                len(attained) / max(n_requests, 1), 3),
            "p50_queue_wait_ms": round(_percentile(waits_ms, 50), 2),
            "p99_queue_wait_ms": round(_percentile(waits_ms, 99), 2),
        })

    stress = out_levels[-1]
    return {
        "replicas": replicas,
        "slots": slots,
        "requests_per_level": n_requests,
        "base_rps": round(base_rps, 2),
        "slo_ms": round(slo_s * 1000, 1),
        "levels": out_levels,
        "goodput_rps": max(lv["goodput_rps"] for lv in out_levels),
        "slo_attainment": stress["slo_attainment"],
        "p50_queue_wait_ms": stress["p50_queue_wait_ms"],
        "p99_queue_wait_ms": stress["p99_queue_wait_ms"],
        "valid": valid,
        "note": ("offered-load sweep vs self-calibrated pool "
                 "capacity; goodput = SLO-attained completions/s; "
                 "p50/p99 waits are the HIGHEST level's (stress) "
                 "admission-queue waits"),
    }


__all__ = ["gateway_probe", "probe_model"]
