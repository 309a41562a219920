"""KV-tiering probe: promote against recompute, and a churn wave.

The port of ``k8s_dra_driver_tpu/serving_kv/tierprobe.py``.  It records:

- ``tier_promote_ms``: the wall of one shared-prefix request served by
  PROMOTION (the prefix was demoted to the host arena; the hit verifies
  the slab's checksum, copies it into fresh blocks and prefills only
  the suffix), the best of ``repeats``;
- ``recompute_ms``: the same request on a tier-less twin whose store
  dropped the prefix (a full-prompt prefill), the best of ``repeats``;
- ``tier_recompute_win_x``: recompute over promote; above 1 moving the
  bytes back beats recomputing them;
- ``tier_hit_frac``: the prefix store's hit share over a churn wave of
  three rotating prompts through a store held to two entries, so
  entries keep demoting and promoting; without tiers these hits are
  misses.

Correctness rides in the same run: the tiered engine's streams must
equal the recompute twin's, greedy and sampled (``byte_equal``).  The
two compute the prompt differently (the twin's one full-prompt prefill
against the promoted rows plus a suffix fill), so in bf16 they round
apart and their streams may part; in f32 they agree.

Its default model is the JAX probe's: vocab 64, d_model 256, 4 layers
of 8 heads of 32 (as many KV heads), d_ff 1024, max_seq the prefix plus
16 rounded up to whole blocks, f32 (on the card K1 runs at head dim
32).  A caller may pass its own ``cfg`` and ``params`` (the on-card
smoke also passes the 154M).  Prompts come from numpy generators.
``python -m k8s_dra_driver_tpu_torch.serving_kv.tierprobe`` prints the
probe's JSON line (the JAX command's flags, plus ``--device``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.serving import Request, ServingEngine
from ..models.transformer import TransformerConfig, init_params
from ..utils.device import resolve_device

#: the engines' block size, the JAX probe's
_BLOCK = 16


def probe_config(d_model: int = 256, n_layers: int = 4,
                 prefix_len: int = 112) -> TransformerConfig:
    """The probe's default model, the JAX probe's: vocab 64, 8 heads of
    ``d_model // 8`` (as many KV heads), d_ff 4 x d_model, max_seq
    ``prefix_len + 16`` rounded up to whole blocks, f32."""
    return TransformerConfig(vocab=64, d_model=d_model, n_layers=n_layers,
                             n_heads=8, d_head=d_model // 8,
                             d_ff=4 * d_model,
                             max_seq=-(-(prefix_len + 16) // _BLOCK) * _BLOCK,
                             n_kv_heads=8, dtype=torch.float32)


def _mk(seed: int, n: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, n).astype(
        np.int32)


def serving_tier_probe(prefix_len: int = 112, suffix_len: int = 4,
                       max_new: int = 4, repeats: int = 5,
                       churn_wave: int = 12, d_model: int = 256,
                       n_layers: int = 4, cfg=None, params=None,
                       device="cuda") -> dict:
    """One promote-against-recompute duel and one demote/promote churn
    wave, flattened to scalars.  ``prefix_len`` sets the recompute cost
    a promotion avoids."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if cfg is None:
        cfg = probe_config(d_model, n_layers, prefix_len)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    need = prefix_len + suffix_len + max_new
    max_seq = -(-need // _BLOCK) * _BLOCK
    prefix = _mk(7, prefix_len, cfg.vocab)
    prefix_key = tuple(prefix.tolist())

    def fill_req(tag, i, temp=0.0):
        return Request(uid=f"{tag}{i}",
                       prompt=np.concatenate(
                           [prefix, _mk(300 + i, suffix_len, cfg.vocab)]),
                       max_new=max_new, temperature=temp, seed=11)

    def mk_engine(tiered: bool):
        kw = {"kv_host_bytes": 256 << 20} if tiered else {}
        return ServingEngine(params, cfg, slots=2, max_seq=max_seq,
                             prefix_cache=4, kv_layout="paged",
                             kv_block_size=_BLOCK, device=dev, **kw)

    def isolate_prefix(store):
        """Keep EXACTLY the shared-prefix entry, so every repeat demotes
        one slab of one block count."""
        for key in [k for k in list(store._store) if k != prefix_key]:
            store.drop(np.asarray(key, np.int32))

    def timed(tiered: bool, temp: float = 0.0):
        """Both engines warm the shared prefix, then lose it from the
        device (a flush: demotion on the tiered engine, eviction on the
        twin); the timed request is then a promotion on one side and a
        full-prompt prefill on the other."""
        eng = mk_engine(tiered)
        outs = {}
        best = float("inf")
        for rep in range(repeats):
            eng.submit(Request(uid=f"warm{rep}", prompt=prefix, max_new=1))
            eng.run()
            isolate_prefix(eng._prefix)
            eng._prefix.flush()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            eng.submit(fill_req("d", rep, temp))
            t = time.perf_counter()
            done = eng.run()
            best = min(best, time.perf_counter() - t)
            for f in done:
                if not f.uid.startswith("warm"):
                    outs[f.uid] = np.asarray(f.tokens)
        return best, outs, eng

    def same(a: dict, b: dict) -> bool:
        return set(a) == set(b) and all(np.array_equal(a[u], b[u])
                                        for u in a)

    promote_s, tiered_out, tiered_eng = timed(True)
    recompute_s, twin_out, _ = timed(False)
    byte_equal = same(tiered_out, twin_out)
    promoted = tiered_eng._prefix.promotions
    # sampled rows must match too (the same seed on both sides)
    _, t_samp, _ = timed(True, temp=0.8)
    _, r_samp, _ = timed(False, temp=0.8)
    byte_equal = byte_equal and same(t_samp, r_samp)

    churn = mk_engine(True)
    churn._prefix.entries = 2            # every third insert demotes
    for i in range(churn_wave):
        churn.submit(fill_req("c", i % 3))
        churn.run()
    cst = churn._prefix
    hit_frac = cst.hits / max(1, cst.hits + cst.misses)

    return {
        "tier_promote_ms": promote_s * 1e3,
        "tier_recompute_win_x": recompute_s / promote_s,
        "tier_hit_frac": hit_frac,
        "recompute_ms": recompute_s * 1e3,
        "promotions": int(promoted),
        "churn_tier_hits": int(cst.tier_hits),
        "churn_promotions": int(cst.promotions),
        "churn_demotions": int(cst.demotions),
        "byte_equal": bool(byte_equal),
        "device": str(dev),
        "wall_s": time.perf_counter() - t0,
        "note": (f"{prefix_len}-token shared prefix, {suffix_len}-token "
                 f"suffixes, d_model={cfg.d_model} x {cfg.n_layers} "
                 f"layers, {cfg.dtype}; promote = crc-verified host slab "
                 f"copied to the device + suffix prefill, against a "
                 f"full-prompt prefill"),
    }


def main(argv=None) -> int:
    """``python -m k8s_dra_driver_tpu_torch.serving_kv.tierprobe``: the probe's
    JSON line, on the card unless ``--device cpu``."""
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--prefix-len", type=int, default=112)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    print(json.dumps(serving_tier_probe(repeats=ns.repeats,
                                        prefix_len=ns.prefix_len,
                                        device=ns.device)))
    return 0


__all__ = ["main", "probe_config", "serving_tier_probe"]


if __name__ == "__main__":
    raise SystemExit(main())
