"""Multi-adapter serving probe: a churn wave and a switch/cold-load duel.

The port of ``k8s_dra_driver_tpu/serving_lora/probe.py``.  It records:

- ``lora_switch_ms``: pinning an adapter that is already resident (the
  ledger's hit path: a refcount bump and an LRU touch, no device
  traffic), the best of ``repeats``;
- ``lora_coldload_ms``: evict-then-acquire of the same adapter, every
  low-rank leaf written into its pool slot in place, timed to a
  readback of the slot (which waits for the copies), the best of
  ``repeats``;
- ``lora_resident_hit_frac``: the warm-hit share of a churn wave of
  mixed-adapter requests through one ``ServingEngine`` whose pool is
  smaller than its working set (``n_adapters > n_resident``), so the
  wave evicts and cold-loads while rows of different adapters decode in
  one batch.

Correctness rides in the same run: every churn output must be byte-equal
to an oracle, a fresh engine with an identical (seed-regenerated) pool
serving only that adapter's requests.  The oracle engines have the churn
engine's slot count (the JAX probe's have one slot): every product then
has the same shapes as in the churn engine, so the card picks the same
algorithms and rounds the same way.

Its default model is the JAX probe's config: vocab 64, d_model 64, 2
layers of 4 heads of 16 over 2 KV heads, d_ff 256, max_seq 96 (on the
card K1 runs at head dim 16).  A caller may pass its own ``cfg`` and
``params`` (the on-card smoke also passes the 154M).  ``python -m
k8s_dra_driver_tpu_torch.serving_lora.probe`` prints the probe's JSON
line (the JAX command's flags, plus ``--device``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.serving import Request, ServingEngine
from ..models.transformer import TransformerConfig, init_params
from ..utils.device import resolve_device
from .pool import AdapterManifest, AdapterPool, make_adapter

#: churn-wave adapter tags, cycled over the wave: a base-model row,
#: repeats (warm hits), and three adapters over two resident slots
#: (evictions and cold loads)
_CHURN_PATTERN = ("l-0", "l-0", None, "l-1", "l-1", "l-2", "l-0", "l-2")


def probe_config(dtype=torch.float32) -> TransformerConfig:
    """The probe's default model, the JAX probe's: vocab 64, d_model
    64, 2 layers of 4 heads of 16 over 2 KV heads, d_ff 256, max_seq
    96."""
    return TransformerConfig(vocab=64, d_model=64, n_layers=2, n_heads=4,
                             d_head=16, d_ff=256, max_seq=96, n_kv_heads=2,
                             dtype=dtype)


def _fresh_pool(cfg, rank: int, n_resident: int, n_adapters: int, device):
    """A pool with ``n_adapters`` seed-regenerated adapters: every call
    gives byte-identical weights, so the churn engine and the oracle
    engines agree on what ``l-i`` means."""
    pool = AdapterPool(cfg, rank, n_resident=n_resident, device=device)
    for i in range(n_adapters):
        pool.register(AdapterManifest(
            f"l-{i}", rank, tenant="probe",
            source=make_adapter(cfg, rank, seed=40 + i)))
    return pool


def _sync(pool: AdapterPool, slot: int) -> float:
    """Wait for every queued write to ``slot`` by reading one of its
    values back."""
    return float(pool.buffers[0][0][slot, 0, 0])


def lora_serving_probe(wave: int = 16, n_adapters: int = 3,
                       n_resident: int = 2, rank: int = 2, max_new: int = 8,
                       repeats: int = 5, slots: int = 4, cfg=None,
                       params=None, device="cuda") -> dict:
    """One byte-equality churn pass and one timed duel, flattened to
    scalars (module docstring).  ``cfg``/``params`` default to
    :func:`probe_config` in f32 with ``init_params`` from seed 0."""
    t0 = time.perf_counter()
    if cfg is None:
        cfg = probe_config()
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
    plen = 8

    def prompt(i):
        rng = np.random.default_rng(100 + i)
        return rng.integers(0, cfg.vocab, plen).astype(np.int32)

    def adapter_of(i):
        return _CHURN_PATTERN[i % len(_CHURN_PATTERN)]

    # -- churn wave: rows of mixed adapters through one small pool ------
    pool = _fresh_pool(cfg, rank, n_resident, n_adapters, device)
    eng = ServingEngine(params, cfg, slots=slots, adapter_pool=pool,
                        device=device)
    for i in range(wave):
        eng.submit(Request(uid=f"r{i}", prompt=prompt(i), max_new=max_new,
                           adapter=adapter_of(i)))
    outs = {f.uid: np.asarray(f.tokens, np.int32) for f in eng.run()}
    hits, colds = pool.hits_total, pool.cold_loads_total
    evictions = pool.evictions_total
    hit_frac = hits / max(1, hits + colds)

    # -- oracles: one engine per adapter, serving only its requests -----
    byte_equal = len(outs) == wave
    for name in sorted({adapter_of(i) for i in range(wave)}, key=str):
        o_pool = _fresh_pool(cfg, rank, n_resident, n_adapters, device)
        o_eng = ServingEngine(params, cfg, slots=slots, adapter_pool=o_pool,
                              device=device)
        for i in range(wave):
            if adapter_of(i) == name:
                o_eng.submit(Request(uid=f"o{i}", prompt=prompt(i),
                                     max_new=max_new, adapter=name))
        for f in o_eng.run():
            byte_equal &= bool(np.array_equal(
                np.asarray(f.tokens, np.int32), outs[f"r{f.uid[1:]}"]))

    # -- duel: resident switch against evict-then-cold-load -------------
    d_pool = _fresh_pool(cfg, rank, n_resident, n_adapters, device)
    d_pool.release(d_pool.acquire("l-0"))       # make it resident
    _sync(d_pool, d_pool.slot_of("l-0"))
    switch_s = float("inf")
    for _ in range(repeats):
        t = time.perf_counter()
        slot = d_pool.acquire("l-0")            # warm: the ledger only
        switch_s = min(switch_s, time.perf_counter() - t)
        d_pool.release(slot)
    cold_s = float("inf")
    for _ in range(repeats):
        if not d_pool.evict("l-0"):
            raise RuntimeError("the duel's adapter is pinned")
        t = time.perf_counter()
        slot = d_pool.acquire("l-0")            # writes every leaf
        _sync(d_pool, slot)
        cold_s = min(cold_s, time.perf_counter() - t)
        d_pool.release(slot)

    dev = resolve_device(device)
    return {
        "lora_switch_ms": switch_s * 1e3,
        "lora_coldload_ms": cold_s * 1e3,
        "lora_resident_hit_frac": hit_frac,
        "churn_hits": hits,
        "churn_cold_loads": colds,
        "churn_evictions": evictions,
        "wave": wave,
        "n_adapters": n_adapters,
        "n_resident": n_resident,
        "rank": rank,
        "slots": slots,
        "bytes_per_slot": d_pool.bytes_per_slot,
        "byte_equal": bool(byte_equal),
        "dtype": str(cfg.dtype).removeprefix("torch."),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "wall_s": time.perf_counter() - t0,
        "note": (f"churn wave of {wave} mixed-adapter requests "
                 f"({n_adapters} adapters over {n_resident} resident "
                 f"slots, {slots} engine slots) byte-equal to per-adapter "
                 "oracle engines of the same slot count; duel is a warm "
                 "ledger pin against a full cold load of the same adapter"),
    }


def main(argv=None) -> int:
    """``python -m k8s_dra_driver_tpu_torch.serving_lora.probe``: the probe's
    JSON line, on the card unless ``--device cpu``."""
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--wave", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    print(json.dumps(lora_serving_probe(wave=ns.wave,
                                        repeats=ns.repeats,
                                        device=ns.device)))
    return 0


__all__ = ["lora_serving_probe", "main", "probe_config"]


if __name__ == "__main__":
    raise SystemExit(main())
