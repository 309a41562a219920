"""Observatory overhead probe: what the quantitative observability
layer costs, and how much device memory it can explain.

The port's copy of ``k8s_dra_driver_tpu/gateway/obsprobe.py``.  Two
scalars:

- ``digest_overhead_x``: paired closed-loop saturation drives over a
  no-op-engine ShardedGateway with the streaming quantile digests
  (utils/digest.py) swapped off (``NullDigestBank``) then on,
  back-to-back per rep so host drift cancels in each ratio, median of
  the paired ratios.  The digest-on arm also renders the merged
  exposition once per drive, so the merge path is inside the measured
  window, not just the observes.  Host work only: no engine launches
  anything.
- ``hbm_accounted_frac``: a MemWatch ledger (utils/memwatch.py)
  accounts a real paged ServingEngine on ``device`` — params, the
  paged-KV pool reservation, a synthetic two-moment optimizer state,
  and the kernel build directory — then reconciles against the card's
  allocator (``device="cuda"``, the default) or against itself
  (``device="cpu"``).  ``cfg=None`` takes the reference probe's tiny
  config (d_head 8: on the card K1 and K2 run at head dim 8).
"""

from __future__ import annotations

import gc
import time

import numpy as np

from .ctlprobe import NullEngine

#: fleet quantiles the probe reports from the merged digest — proof
#: the measured run actually exercised the merge contract
_PROOF_QUANTILES = ("p50", "p99")


def observatory_probe(n_requests: int = 768, reps: int = 9,
                      pumps: int = 2, replicas: int = 4,
                      slots: int = 8, prompt_len: int = 12,
                      queue_capacity: int = 192,
                      seed: int = 0, cfg=None,
                      device="cuda") -> dict:
    """The paired digest-on/off drive + HBM accounting pass
    (module docstring); ``cfg`` and ``device`` shape the accounted
    engine."""
    import torch

    from ..models.serving import Request, ServingEngine
    from ..models.transformer import TransformerConfig, init_params
    from ..utils.device import resolve_device
    from ..utils.memwatch import MemWatch, tree_nbytes
    from .replica import ReplicaManager
    from .sharded import ShardedGateway

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def reqs(tag, n):
        return [Request(
            uid=f"{tag}{i}",
            prompt=rng.integers(0, 1000, prompt_len).astype(np.int32),
            max_new=1) for i in range(n)]

    def make_gw(digests: bool) -> ShardedGateway:
        mgr = ReplicaManager(
            lambda name: NullEngine(slots=slots),
            replicas=replicas, depth_bound=slots)
        return ShardedGateway(
            mgr, pumps=pumps,
            queue_capacity=max(queue_capacity // pumps, 1),
            seed=seed, digests=digests)

    # generous SLO: shedding would measure deadline math, not sketch
    # cost (the same reasoning as the ctl probe's slo_x)
    slo_s = 3600.0

    def saturate(gw, rl) -> float:
        i = 0
        t0 = time.perf_counter()
        while i < len(rl):
            while i < len(rl) and gw.pending() < queue_capacity:
                gw.submit(rl[i], slo_s)
                i += 1
            gw.step()
        gw.run_until_idle()
        dig = gw.pumps[0].digests.get("queue_wait")
        if dig is not None and dig.count:
            # digest-on arm: the production render path (merge across
            # pumps + summary exposition) is part of what rides along
            gw.metrics.render()
        return time.perf_counter() - t0

    # warmup, discarded: first-drive one-time costs (metric label
    # creation, allocator warmth) must not land on one arm
    saturate(make_gw(True), reqs("warm_", n_requests))

    ratios: list[float] = []
    merged_counts: list[int] = []
    per_pump_counts: list[list[int]] = []
    proof: dict = {}
    for r in range(reps):
        pair = {}
        for on in (False, True):
            gw = make_gw(on)
            rl = reqs(f"d{'on' if on else 'off'}{r}_", n_requests)
            gc.collect()
            pair[on] = saturate(gw, rl)
            if on:
                merged = gw.merged_digests()
                dig = merged.get("queue_wait")
                merged_counts.append(dig.count if dig else 0)
                per_pump_counts.append(
                    [p.digests.get("queue_wait").count
                     for p in gw.pumps])
                # merged == whole-stream: rebuild the whole-stream
                # digest from the per-pump parts the OTHER way and
                # compare the fleet quantiles (exact bucket equality
                # is pinned in tests/test_digest.py)
                snap = dig.snapshot() if dig else {}
                proof = {q: snap.get(q) for q in _PROOF_QUANTILES}
        ratios.append(pair[True] / max(pair[False], 1e-9))
    digest_overhead_x = round(float(np.median(ratios)), 3)

    # -- HBM accounting over a real paged engine on the device -------
    if cfg is None:
        cfg = TransformerConfig(vocab=64, d_model=32, n_layers=2,
                                n_heads=4, d_head=8, d_ff=64,
                                max_seq=48, n_kv_heads=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    # the reference's 32 blocks of 8, or one full sequence (plus the
    # null block) where max_seq needs more
    engine = ServingEngine(params, cfg, slots=2, kv_layout="paged",
                           kv_block_size=8,
                           kv_blocks=max(32, cfg.max_seq // 8 + 1),
                           device=dev)
    mw = MemWatch(device=dev)
    mw.account_engine(engine, unit="r0")
    # synthetic Adam-shaped optimizer state: two moment trees the
    # size of params (the training-side component the serving engine
    # does not carry)
    mw.account("opt_state", 2 * tree_nbytes(params), unit="gang0")
    mw.account_compile_cache()
    hbm = mw.snapshot()

    # every drive must have observed every dispatch, and the merged
    # count must equal the sum of the per-pump parts
    valid = (bool(merged_counts)
             and all(c == n_requests for c in merged_counts)
             and all(sum(pp) == n_requests
                     for pp in per_pump_counts)
             and all(len([c for c in pp if c > 0]) >= 1
                     for pp in per_pump_counts)
             and digest_overhead_x > 0)
    return {
        "n_requests": n_requests,
        "reps": reps,
        "pumps": pumps,
        "replicas": replicas,
        "slots": slots,
        "digest_overhead_x": digest_overhead_x,
        "digest_ratios": [round(x, 4) for x in ratios],
        "merged_digest_count": merged_counts[-1] if merged_counts
        else 0,
        "per_pump_counts": per_pump_counts[-1] if per_pump_counts
        else [],
        "merged_quantiles": proof,
        "hbm_accounted_frac": round(hbm["accounted_frac"], 4),
        "hbm_accounted_bytes": hbm["accounted_bytes"],
        "hbm_device_bytes": hbm["device_bytes_in_use"],
        "hbm_device_source": hbm["device_source"],
        "hbm_components": hbm["components"],
        "valid": valid,
        "note": ("paired digest-off/on closed-loop saturation over "
                 "NO-OP engines (median of per-rep paired ratios, "
                 "gc-fenced); digest-on arm includes the merged "
                 "render path; HBM ledger reconciled against "
                 f"{hbm['device_source']} bytes"),
    }


__all__ = ["observatory_probe"]
