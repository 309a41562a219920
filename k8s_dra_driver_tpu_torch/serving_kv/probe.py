"""Paged-KV probe: block-ledger economics as scalars.

The port of ``k8s_dra_driver_tpu/serving_kv/probe.py``.  It records:

- ``pg_max_concurrent_x`` — peak simultaneously-active requests at a
  FIXED synthetic device-memory budget (the same count of usable KV
  rows for both engines), paged / contiguous.  The contiguous engine
  must reserve ``max_seq`` rows per slot up front, so the budget caps
  its slot count; the paged engine allocates blocks as sequences grow
  and CoW-shares the common prefix, so the same rows hold more live
  requests.
- ``pg_cow_shared_frac`` — peak fraction of the usable block pool held
  by CoW-shared blocks during the wave (> 0: the sharing is real).
- ``pg_decode_tok_s_ratio`` — decode throughput of the paged engine
  over the contiguous engine on the identical workload (outputs are
  checked byte-equal in the same run, ``byte_equal``).

Its default model is the reference probe's (vocab 64, d_model 128, 2
layers, 8 heads of 16 over 4 KV heads, d_ff 512, max_seq 48, f32): on
the card every prompt fill runs K1 and every paged step K2 at head dim
16.  A caller may pass its own ``cfg`` (the on-card smoke also passes
the 154M).  Prompts come from numpy generators.  ``python -m
k8s_dra_driver_tpu_torch.serving_kv.probe`` prints the probe's JSON
line (the JAX command's flags, plus ``--device``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.serving import Request, ServingEngine
from ..models.transformer import TransformerConfig, init_params
from ..utils.device import resolve_device


def probe_config(dtype=torch.float32) -> TransformerConfig:
    """The probe's default model, the JAX probe's: vocab 64, d_model
    128, 2 layers of 8 heads of 16 over 4 KV heads, d_ff 512, max_seq
    48."""
    return TransformerConfig(vocab=64, d_model=128, n_layers=2, n_heads=8,
                             d_head=16, d_ff=512, max_seq=48, n_kv_heads=4,
                             dtype=dtype)


def _mk(seed: int, n: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, n).astype(
        np.int32)


def _pump(eng) -> tuple[dict, int, float]:
    """Step to idle; return (finished by uid, peak active slots, peak
    CoW-shared fraction of the usable pool)."""
    done: dict = {}
    peak, cow = 0, 0.0
    usable = (eng.kv_manager.n_blocks - 1
              if hasattr(eng, "kv_manager") else 0)
    while eng.occupancy()["depth"] > 0:
        for f in eng.step():
            done[f.uid] = f
        occ = eng.occupancy()
        peak = max(peak, occ["active"])
        if usable:
            cow = max(cow, occ["kv_cow_shared_blocks"] / usable)
    return done, peak, cow


def paged_kv_probe(prefix_len: int = 16, suffix_len: int = 4,
                   max_new: int = 6, timed_new: int = 24,
                   wave: int = 6, repeats: int = 5, cfg=None,
                   device="cuda") -> dict:
    """One fixed-budget concurrency wave + one timed throughput duel,
    flattened to scalars.  ``max_new`` shapes the concurrency wave
    (short, so block economics — not sequence growth — set the peak);
    ``timed_new`` shapes the timed duel (long, so decode dominates the
    measured wall).  ``cfg`` (default: the reference probe's) gets
    weights from generator seed 0 on ``device``."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if cfg is None:
        cfg = probe_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    bs = 16
    tw = cfg.max_seq // bs
    # the synthetic budget: exactly 2 contiguous slots' worth of KV
    # rows.  Contiguous spends it on 2 fixed slabs; paged gets the same
    # usable rows as 2*tw blocks (+ the pinned null block, which holds
    # no sequence data)
    contig_slots = 2
    usable_blocks = contig_slots * tw
    prefix = _mk(7, prefix_len, cfg.vocab)

    def reqs(tag, n_new):
        return [Request(uid=f"{tag}{i}",
                        prompt=np.concatenate(
                            [prefix, _mk(100 + i, suffix_len, cfg.vocab)]),
                        max_new=n_new) for i in range(wave)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- concurrency at fixed budget ----------------------------------
    paged = ServingEngine(params, cfg, slots=wave, kv_layout="paged",
                          kv_block_size=bs, kv_blocks=usable_blocks + 1,
                          device=dev)
    # seed the store so the wave CoW-adopts the prefix block instead of
    # each slot paying for its own copy (the steady-state shape: a
    # system prompt is hot long before any burst)
    paged.submit(Request(uid="warm", prompt=prefix, max_new=1))
    paged.run()
    for r in reqs("p", max_new):
        paged.submit(r)
    paged_done, paged_peak, cow_frac = _pump(paged)

    contig = ServingEngine(params, cfg, slots=contig_slots,
                           prefix_cache=2, device=dev)
    contig.submit(Request(uid="warm", prompt=prefix, max_new=1))
    contig.run()
    for r in reqs("p", max_new):
        contig.submit(r)
    contig_done, contig_peak, _ = _pump(contig)
    byte_equal = all(
        np.array_equal(paged_done[u].tokens, contig_done[u].tokens)
        for u in paged_done)

    # -- decode throughput, identical engines but for the layout ------
    def timed(factory) -> float:
        best = float("inf")
        for _ in range(repeats):
            eng = factory()
            eng.submit(Request(uid="warm", prompt=prefix, max_new=1))
            eng.run()                     # store warm
            for r in reqs("t", timed_new):
                eng.submit(r)
            sync()
            t = time.perf_counter()
            eng.run()
            sync()
            best = min(best, time.perf_counter() - t)
        return best

    # the duel measures the gather indirection, not scarcity: the paged
    # engine gets slot capacity PLUS store headroom (the contiguous
    # side's prefix_cache entries are dense copies that live outside
    # its slab budget too), so neither side preempts
    tokens = wave * timed_new
    paged_s = timed(lambda: ServingEngine(
        params, cfg, slots=contig_slots, kv_layout="paged",
        kv_block_size=bs, kv_blocks=2 * usable_blocks + 1, device=dev))
    contig_s = timed(lambda: ServingEngine(
        params, cfg, slots=contig_slots, prefix_cache=2, device=dev))
    return {
        "pg_max_concurrent_x": round(paged_peak / contig_peak, 3),
        "pg_cow_shared_frac": round(cow_frac, 4),
        "pg_decode_tok_s_ratio": round(contig_s / paged_s, 3),
        "paged_peak_active": paged_peak,
        "contig_peak_active": contig_peak,
        "budget_rows": usable_blocks * bs,
        "paged_tok_s": round(tokens / paged_s, 1),
        "contig_tok_s": round(tokens / contig_s, 1),
        "alloc_failures": paged.stats()["kv_alloc_failures_total"],
        "byte_equal": bool(byte_equal),
        "wall_s": round(time.perf_counter() - t0, 3),
        "note": (f"fixed budget {usable_blocks * bs} KV rows "
                 f"(+null block), bs={bs}, wave={wave} requests "
                 f"sharing a {prefix_len}-token prefix"),
    }


def main(argv=None) -> int:
    """``python -m k8s_dra_driver_tpu_torch.serving_kv.probe``: the probe's
    JSON line, on the card unless ``--device cpu``."""
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--wave", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    print(json.dumps(paged_kv_probe(wave=ns.wave, repeats=ns.repeats,
                                    device=ns.device)))
    return 0


__all__ = ["main", "paged_kv_probe", "probe_config"]


if __name__ == "__main__":
    raise SystemExit(main())
