"""Speculative-decode probe: the fused duel as two scalars.

The port of ``k8s_dra_driver_tpu/models/specprobe.py`` (its own copy:
the port imports nothing of the JAX package).  It records:

- ``spec_tok_s_x``: decode tokens/s of a fused speculative engine
  (``draft_source="ngram"`` inside ``chain_steps`` blocks) over the
  identical engine without speculation, on the same batch of greedy
  requests;
- ``spec_accept_rate``: accepted / proposed drafts for the run (the
  engine's ``spec_accept_rate`` counter).

The duel model is an **induction ramp** built so the n-gram draft is
exact rather than lucky: every ``wo`` / ``w_out`` projection is zeroed,
so the residual stream is the token embedding untouched, and the
unembedding is the rms-normed embedding table rolled by one row, so the
greedy argmax is ``(last + 1) mod vocab``.  The self dot product
(``d_model``) dominates the cross terms (about ``sqrt(d_model)``) so
widely that the ramp is exact in bf16 too.  Prompts are vocab-covering
ramps, so the lookup always finds ``last`` followed by the next
``draft_len`` ramp tokens, which is exactly what the target emits: the
accept rate is near 1.0 by construction, and the probe measures the
speed of the fused verify-accept machinery at full acceptance, while
byte equality against the non-speculative engine and the closed-form
ramp pins its correctness.

Its config is the JAX probe's: vocab 32, d_model 128, 2 layers of 8
heads of 16 over 4 KV heads, d_ff 512, max_seq 128 (on the card every
prompt fill runs K1 at head dim 16).  ``python -m
k8s_dra_driver_tpu_torch.models.specprobe`` prints the probe's JSON line
(the JAX command's flags, plus ``--device``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .serving import Request, ServingEngine
from .transformer import TransformerConfig, init_params, rms_norm


def probe_config(dtype=torch.float32) -> TransformerConfig:
    """The probe's model, the JAX probe's: vocab 32, d_model 128, 2
    layers of 8 heads of 16 over 4 KV heads, d_ff 512, max_seq 128."""
    return TransformerConfig(vocab=32, d_model=128, n_layers=2, n_heads=8,
                             d_head=16, d_ff=512, max_seq=128, n_kv_heads=4,
                             dtype=dtype)


def _ramp(start: int, length: int, vocab: int) -> np.ndarray:
    return ((start + np.arange(length)) % vocab).astype(np.int32)


def _induction_params(cfg: TransformerConfig, seed: int = 0,
                      device="cuda"):
    """``init_params`` rewired into an induction ramp: zeroed output
    projections keep the residual equal to the embedding, and the
    rolled unembedding makes the greedy argmax ``(token + 1) mod
    vocab``."""
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device=device)
    for layer in params["layers"]:
        layer["wo"] = torch.zeros_like(layer["wo"])
        layer["w_out"] = torch.zeros_like(layer["w_out"])
    normed = rms_norm(params["embed"].float(), params["ln_f"].float())
    # column v holds the normed embedding of token v - 1, so the logits
    # peak at last + 1
    params["unembed"] = torch.roll(normed, 1, dims=0).T.contiguous().to(
        cfg.dtype)
    return params


def spec_decode_probe(wave: int = 4, timed_new: int = 45,
                      draft_len: int = 8, chain_steps: int = 8,
                      repeats: int = 5, dtype=torch.float32,
                      device="cuda") -> dict:
    """One byte-equality pass and one timed duel, flattened to scalars.
    ``wave`` requests decode ``timed_new`` tokens each on a speculative
    engine (n-gram drafts fused into the blocks) and its
    non-speculative twin; both outputs must match each other AND the
    closed-form ramp before any timing counts.  On the card the timed
    runs end in a synchronize."""
    t0 = time.perf_counter()
    cfg = probe_config(dtype)
    params = _induction_params(cfg, device=device)
    # prompts cover the vocab cycle with draft_len lookahead, so every
    # generated ``last`` has an in-prompt match followed by the exact
    # ramp continuation the target emits
    plen = cfg.vocab + draft_len

    def reqs(n_new):
        return [Request(uid=f"r{i}", prompt=_ramp(5 + 3 * i, plen, cfg.vocab),
                        max_new=n_new) for i in range(wave)]

    def spec_eng():
        return ServingEngine(params, cfg, slots=wave, draft_source="ngram",
                             draft_len=draft_len, chain_steps=chain_steps,
                             device=device)

    def base_eng():
        return ServingEngine(params, cfg, slots=wave,
                             chain_steps=chain_steps, device=device)

    # -- byte equality: spec == plain == closed-form ramp ---------------
    outs = {}
    for tag, factory in (("spec", spec_eng), ("base", base_eng)):
        eng = factory()
        for r in reqs(timed_new):
            eng.submit(r)
        outs[tag] = {f.uid: f.tokens for f in eng.run()}
        if tag == "spec":
            stats = eng.stats()
            accept_rate = stats["spec_accept_rate"]
            windows = stats["speculative_windows_total"]
    byte_equal = True
    for i in range(wave):
        # Finished.tokens is the whole sequence, one closed-form ramp
        want = _ramp(5 + 3 * i, plen + timed_new, cfg.vocab)
        for tag in ("spec", "base"):
            got = np.asarray(outs[tag][f"r{i}"], np.int32)
            byte_equal &= bool(np.array_equal(got, want))

    # -- decode throughput, identical engines but for the drafts --------
    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def timed(factory) -> float:
        best = float("inf")
        for _ in range(repeats):
            eng = factory()
            # the same traffic once on the same engine first: the timed
            # run replays graphs captured before it
            for r in reqs(timed_new):
                eng.submit(Request(uid="warm-" + r.uid, prompt=r.prompt,
                                   max_new=r.max_new))
            eng.run()
            for r in reqs(timed_new):
                eng.submit(r)
            sync()
            t = time.perf_counter()
            eng.run()
            sync()
            best = min(best, time.perf_counter() - t)
        return best

    tokens = wave * timed_new
    spec_s = timed(spec_eng)
    base_s = timed(base_eng)
    return {
        "spec_tok_s_x": round(base_s / spec_s, 3),
        "spec_accept_rate": accept_rate,
        "spec_tok_s": round(tokens / spec_s, 1),
        "base_tok_s": round(tokens / base_s, 1),
        "spec_windows": windows,
        "draft_len": draft_len,
        "chain_steps": chain_steps,
        "byte_equal": bool(byte_equal),
        "dtype": str(dtype).removeprefix("torch."),
        "wall_s": round(time.perf_counter() - t0, 3),
        "note": (f"induction-ramp duel: {wave} greedy requests x "
                 f"{timed_new} tokens, ngram drafts (k={draft_len}) "
                 f"fused into chain_steps={chain_steps}; accept rate "
                 "is the mechanism ceiling by construction"),
    }


def main(argv=None) -> int:
    """``python -m k8s_dra_driver_tpu_torch.models.specprobe``: the
    probe's JSON line, on the card unless ``--device cpu``."""
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--wave", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    print(json.dumps(spec_decode_probe(wave=ns.wave, repeats=ns.repeats,
                                       device=ns.device)))
    return 0


__all__ = ["main", "probe_config", "spec_decode_probe"]


if __name__ == "__main__":
    raise SystemExit(main())
