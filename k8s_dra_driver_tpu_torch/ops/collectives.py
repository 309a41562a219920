"""Collective helpers and the measurement harness, on CUDA events.

The port of ``k8s_dra_driver_tpu/ops/collectives.py``.  Every probe
here times a *chain*: ``make(n)`` returns a callable that runs ``n``
dependent iterations and returns a scalar, and the per-iteration time
is the difference between a long and a short chain, so fixed per-call
overhead (launch, the host's enqueue of the first kernel, the final
readback) cancels.  The harness's rules are the reference's:

- every timed call gets a fresh input (``arg + k``), so nothing can be
  served from a previous result, after one warm call;
- the median over trials of the long-minus-short differential is the
  reading; a non-positive median (jitter swamped it) falls back to the
  absolute per-iteration time and is flagged ``valid=False``;
- a reading below a physical floor (operations over twice the card's
  peak, bytes over 2.5x its memory rate) is an artifact, in the
  flattering direction, and is retried, then flagged.

Timing: a chain whose input lies on one CUDA device is timed with CUDA
events around the call (``elapsed_time`` after the end event completes);
a chain over several devices on the host clock between synchronizes of
every device; a CPU chain on the host clock around ``float(result)``.
A CPU reading is a CPU reading: the probes say which device they ran
on, and no floor applies there.

The probes drive the port's main paths: K1 (``flash_attention``) in
:func:`attention_probe`, K1 with K3/K4 in :func:`attention_grad_probe`,
``greedy_generate`` (K1 prefill, K7 on int8 weights) in
:func:`decode_probe`, ``ServingEngine`` in :func:`serving_probe` and
:func:`dispatch_probe`.  Each returns the JAX probe's keys.  The
reference's Pallas block arguments (``block_q``, ``block_k``,
``interpret``) have no counterpart: the port's kernels take no block
sizes from their callers.
"""

from __future__ import annotations

import functools
import statistics
import time

import numpy as np
import torch

from ..utils.device import resolve_device


def _devices_of(arg) -> list[torch.device]:
    """The CUDA devices ``arg`` (a tensor or a list of tensors) lies on."""
    items = arg if isinstance(arg, (list, tuple)) else [arg]
    out = []
    for a in items:
        if isinstance(a, torch.Tensor) and a.device.type == "cuda" \
                and a.device not in out:
            out.append(a.device)
    return out


def _fresh(arg, k: int):
    """The reference's ``arg + float(k)``: a new input for every timed
    call (integer tensors stay integer)."""
    if isinstance(arg, (list, tuple)):
        return [a + k for a in arg]
    return arg + k


def _timed_call(fn, arg) -> float:
    """Seconds of one ``fn(arg)``, its scalar result read back."""
    devices = _devices_of(arg)
    if len(devices) == 1:
        with torch.cuda.device(devices[0]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(arg)
            end.record()
            end.synchronize()
            float(out)
            return start.elapsed_time(end) / 1000.0
    for d in devices:
        torch.cuda.synchronize(d)
    start = time.perf_counter()
    out = fn(arg)
    for d in devices:
        torch.cuda.synchronize(d)
    float(out)
    return time.perf_counter() - start


def _best_time(fn, arg, reps: int = 4) -> float:
    """Best-of-N time of ``fn(arg + k)`` after one warm call.

    A fresh input each rep defeats any reuse of a previous result; the
    scalar readback is the synchronization point (CUDA events on one
    card, see the module docstring).
    """
    float(fn(arg))                      # build + warm
    best = None
    for rep in range(reps):
        t = _timed_call(fn, _fresh(arg, rep + 1))
        best = t if best is None else min(best, t)
    return best


def _differential_median(long_fn, short_fn, arg, iters: int, short: int,
                         trials: int = 3, reps: int = 3):
    """Median marginal per-op time between a long and a short chain.

    Fixed per-call overhead cancels in the difference.  A non-positive
    median means jitter swamped the differential; fall back to the
    absolute (overhead-included, conservative) per-op time and flag it
    ``valid=False``.  Returns (elapsed_seconds, valid, t_short_last).
    """
    marginals, t_short, t_long = [], 0.0, 0.0
    for _ in range(trials):
        t_short = _best_time(short_fn, arg, reps=reps)
        t_long = _best_time(long_fn, arg, reps=reps)
        if iters > short:
            marginals.append((t_long - t_short) / (iters - short))
        else:
            marginals.append(t_long / iters)
    marginals.sort()
    elapsed = marginals[len(marginals) // 2]
    valid = elapsed > 0
    if not valid:
        elapsed = t_long / iters
    return elapsed, valid, t_short


def _chain_devices(devices) -> list[torch.device]:
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] "
                               "to run the one-device chain on the CPU")
        return [torch.device("cuda", i) for i in range(n)]
    out = [resolve_device(d) for d in devices]
    if len(out) > 1 and any(d.type != "cuda" for d in out):
        raise ValueError("an all-reduce over several devices runs on CUDA "
                         f"devices (NCCL), got {out}")
    return out


def allreduce_bandwidth(size_mb: float = 64.0, iters: int = 16,
                        devices: list | None = None) -> dict:
    """Time an all-reduce over ``devices`` (default: every card of this
    process); returns GB/s and latency.

    One process drives every device through ``torch.cuda.nccl
    .all_reduce``; each iteration sums the shards in place and rescales
    them by ``1/n``.  On one device the chain is the rescale alone,
    which is what the reference's one-device psum is (``devices``: 1).
    Differential timing as everywhere here: the marginal per-op cost of
    a long over a short chain, so the fixed per-call overhead cancels.
    """
    devices = _chain_devices(devices)
    n = len(devices)
    nelems = int(size_mb * 1e6 / 4 / max(n, 1)) * n
    x = [torch.arange(nelems, dtype=torch.float32, device=d)
         for d in devices]
    inv = 1.0 / max(n, 1)

    def make(iters):
        def ar(xs):
            ys = [y.clone() for y in xs]
            for _ in range(iters):
                if n > 1:
                    torch.cuda.nccl.all_reduce(ys)
                ys = [y * inv for y in ys]
            return ys[0].sum()
        return ar

    short = max(iters // 4, 1)
    long_fn, short_fn = make(iters), make(short)
    elapsed, valid, t_short_last = _differential_median(
        long_fn, short_fn, x, iters, short, reps=4)

    bytes_moved = nelems * 4
    # ring allreduce moves 2*(n-1)/n of the payload per device
    algo_factor = 2 * (n - 1) / n if n > 1 else 1.0
    return {
        "devices": n,
        "size_mb": bytes_moved / 1e6,
        "seconds": elapsed,
        "valid": valid,
        "dispatch_overhead_ms": max(
            (t_short_last - elapsed * short) * 1000, 0.0),
        "gbps": bytes_moved * algo_factor / elapsed / 1e9,
    }


#: generous physical ceilings used to reject too-good-to-be-true
#: differentials, the reference's headroom over one NVIDIA H100 SXM's
#: published peaks (989 TFLOP/s dense bf16, 3.35 TB/s HBM3 at its 700 W
#: limit): no bf16 kernel beats 2x the tensor-core peak and nothing
#: streams device memory faster than 2.5x its rate, so an elapsed time
#: implying either is a measurement artifact.
_PEAK_TFLOPS_CEILING = 2 * 989.0
_PEAK_HBM_GBPS_CEILING = 2.5 * 3350.0


def _measure_pair(long_fn, short_fn, arg, iters: int, short: int,
                  floor_s: float, retries: int) -> tuple[float, bool]:
    """One differential measurement over an already-built chain pair,
    with the invalid-retry loop (non-positive or below-floor
    differentials are artifacts, either direction)."""
    elapsed, valid = None, False
    for _ in range(retries):
        elapsed, valid, _ = _differential_median(
            long_fn, short_fn, arg, iters, short)
        if valid and elapsed < floor_s:
            valid = False
        if valid:
            break
    return elapsed, valid


def measure_chain(make, arg, iters: int, floor_s: float = 0.0,
                  retries: int = 3) -> tuple[float, bool]:
    """Differential-median timing with artifact rejection.

    ``make(n)`` returns a callable running n dependent iterations.
    Retries while the differential is invalid: non-positive (jitter
    swamped it) or *below ``floor_s``* (impossibly fast, the same
    artifact in the flattering direction).  Returns (seconds, valid).
    """
    short = max(iters // 4, 1)
    long_fn, short_fn = make(iters), make(short)
    return _measure_pair(long_fn, short_fn, arg, iters, short,
                         floor_s, retries)


def measure_chain_samples(make, arg, iters: int, floor_s: float = 0.0,
                          samples: int = 3, retries: int = 3
                          ) -> tuple[float, bool, list]:
    """Median-of-``samples`` differential timing over ONE chain pair.

    A single differential reading can jitter in either direction; the
    repetition lives here, over one built pair.  Returns
    ``(median_elapsed, valid, runs)`` with every sample listed as
    ``{"ms", "valid"}`` so outliers stay visible in recorded results.
    """
    short = max(iters // 4, 1)
    long_fn, short_fn = make(iters), make(short)
    runs = [_measure_pair(long_fn, short_fn, arg, iters, short,
                          floor_s, retries) for _ in range(samples)]
    # median_low over (elapsed, valid) PAIRS: validity comes from the
    # sample actually selected, not from a float-equality match that
    # an elapsed-value collision (or an all-invalid fallback pool)
    # could decide wrongly
    pool = sorted([r for r in runs if r[1]] or runs,
                  key=lambda r: r[0])
    med, valid = pool[(len(pool) - 1) // 2]
    return med, valid, [{"ms": round(e * 1000, 3), "valid": v}
                        for e, v in runs]


def _seeded_normal(shape, seed: int, dtype, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)


def _attention_differential(batch, seq, heads, head_dim, iters, dtype,
                            matmuls, make_body, kv_heads=None,
                            window=None, samples=1,
                            device="cuda") -> dict:
    """Shared flash-vs-naive harness behind both attention probes.

    Identical q/k/v generation (seeded generators 0, 1, 2), physical
    floors, chain construction and result dict; the probes differ only
    in the per-iteration body (``make_body(attn, k, v) -> body(x)``)
    and the matmul count of the FLOP model.  ``kv_heads`` < heads
    probes the grouped-query path (score and output FLOPs unchanged).
    ``samples`` > 1 takes the median of that many flash measurements
    over one chain pair and lists every run under ``flash_ms_runs``.
    """
    from .flash_attention import flash_attention
    from .ring_attention import attention_reference

    device = resolve_device(device)
    shape = (batch, seq, heads, head_dim)
    kv_shape = (batch, seq, kv_heads or heads, head_dim)
    q = _seeded_normal(shape, 0, dtype, device)
    k = _seeded_normal(kv_shape, 1, dtype, device)
    v = _seeded_normal(kv_shape, 2, dtype, device)

    # matmuls x 2 x B*H*T^2*D MACs, causal masking halves the work
    flops = matmuls * 2 * batch * heads * seq * seq * head_dim * 0.5
    on_accel = device.type == "cuda"
    floor_s = flops / (_PEAK_TFLOPS_CEILING * 1e12) if on_accel else 0.0
    # the naive path also writes the f32 score tensor to device memory
    # and reads it back: a bandwidth floor far above its compute floor
    score_bytes = 2 * batch * heads * seq * seq * 4
    naive_floor_s = (max(floor_s, score_bytes
                         / (_PEAK_HBM_GBPS_CEILING * 1e9))
                     if on_accel else 0.0)

    def make_chain(attn):
        body = make_body(attn, k, v)

        def make(n):
            def chain(x):
                for _ in range(n):
                    x = body(x)
                return x.float().sum()
            return chain
        return make

    flash = functools.partial(flash_attention, causal=True, window=window)
    naive = functools.partial(attention_reference, causal=True,
                              window=window)
    flash_runs = None
    if samples > 1:
        t_flash, flash_valid, flash_runs = measure_chain_samples(
            make_chain(flash), q, iters, floor_s, samples=samples)
    else:
        t_flash, flash_valid = measure_chain(make_chain(flash), q,
                                             iters, floor_s)
    t_naive, naive_valid = measure_chain(make_chain(naive), q, iters,
                                         naive_floor_s)
    out = {
        "batch": batch, "seq": seq, "heads": heads, "head_dim": head_dim,
        "kv_heads": kv_heads or heads, "window": window,
        "flash_ms": t_flash * 1000, "naive_ms": t_naive * 1000,
        "flash_tflops": flops / t_flash / 1e12,
        "naive_tflops": flops / t_naive / 1e12,
        "speedup": t_naive / t_flash,
        "valid": flash_valid and naive_valid,
    }
    if flash_runs is not None:
        out["flash_ms_runs"] = flash_runs
    return out


def attention_probe(batch: int = 4, seq: int = 2048, heads: int = 8,
                    head_dim: int = 64, iters: int = 32,
                    dtype=torch.bfloat16, kv_heads: int | None = None,
                    window: int | None = None, samples: int = 1,
                    device="cuda") -> dict:
    """Flash (K1, ``flash_attention``) against naive
    (``attention_reference``) causal attention, forward only.

    Chained differential timing so per-call overhead cancels, plus a
    physical floor so an artifact cannot record the kernel impossibly
    fast.  Reports ms a call and achieved TFLOP/s for both paths and
    the speedup.  No ``block_q``/``block_k``/``interpret``: the port's
    kernel takes no block sizes from its callers.
    """
    def make_body(attn, k, v):
        @torch.no_grad()
        def body(x):
            y = attn(x, k, v)
            return y * 0.5 + x * 0.5
        return body

    # forward only: 2 matmuls
    return _attention_differential(batch, seq, heads, head_dim, iters,
                                   dtype, 2, make_body, kv_heads, window,
                                   samples, device)


def attention_grad_probe(batch: int = 4, seq: int = 2048, heads: int = 8,
                         head_dim: int = 64, iters: int = 16,
                         dtype=torch.bfloat16,
                         kv_heads: int | None = None, samples: int = 1,
                         device="cuda") -> dict:
    """Training-path probe: forward and backward of attention, flash
    (K1, then K3 and K4 through ``flash_attention``'s autograd
    function) against naive autograd of ``attention_reference``; the
    gradient is taken for q alone, as the reference's ``jax.grad`` is.
    Same harness as :func:`attention_probe`; no block arguments."""
    def make_body(attn, k, v):
        def body(x):
            with torch.enable_grad():
                x = x.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(attn(x, k, v).float().sum(), x)
            return (x + g.to(x.dtype) * 1e-3).detach()
        return body

    # fwd 2 matmuls + bwd 5 matmuls
    return _attention_differential(batch, seq, heads, head_dim, iters,
                                   dtype, 7, make_body, kv_heads,
                                   samples=samples, device=device)


def matmul_tflops(dim: int = 4096, iters: int = 400,
                  dtype=torch.bfloat16, device="cuda") -> dict:
    """Matrix-unit yardstick: a chain of square ``torch.matmul``s.

    Data dependencies between iterations (the per-iteration rescale
    keeps bf16 finite without changing the matmul count); the reported
    rate is the marginal cost between a long and a short chain.  A
    yardstick of the card, not a kernel of the port.
    """
    device = resolve_device(device)
    a = _seeded_normal((dim, dim), 0, dtype, device)
    b = a.clone()           # the reference draws both from one key

    def make(iters):
        def chain(x):
            for _ in range(iters):
                x = (x @ b) * (1.0 / dim)
            return x.sum()
        return chain

    short = max(iters // 4, 1)
    long_fn, short_fn = make(iters), make(short)
    elapsed, valid, _ = _differential_median(
        long_fn, short_fn, a, iters, short)
    return {"dim": dim, "seconds": elapsed, "valid": valid,
            "tflops": 2 * dim ** 3 / elapsed / 1e12}


#: decode floor ceiling: decode's minimum device-memory traffic is
#: known exactly (weights + the full static cache a token), so a
#: reading implying more than 1.2x one H100 SXM's 3.35 TB/s (at its
#: 700 W limit) is an artifact, full stop.
_DECODE_HBM_GBPS_CEILING = 1.2 * 3350.0


def _probe_config(vocab, d_model, n_layers, heads, kv_heads, d_ff, max_seq,
                  dtype=torch.bfloat16, **kw):
    from ..models import TransformerConfig
    return TransformerConfig(
        vocab=vocab, d_model=d_model, n_layers=n_layers, n_heads=heads,
        d_head=d_model // heads, n_kv_heads=kv_heads, d_ff=d_ff,
        max_seq=max_seq, dtype=dtype, **kw)


def decode_probe(batch: int = 8, n_layers: int = 8, d_model: int = 1024,
                 heads: int = 16, kv_heads: int = 4, d_ff: int = 4096,
                 prompt_len: int = 128, n_tokens: int = 64,
                 max_seq: int = 2048, reps: int = 3,
                 int8: bool = False, kv_int8: bool = False,
                 device="cuda") -> dict:
    """Serving-path probe: greedy generation through the static-shape
    KV cache (``models/decode.py`` ``greedy_generate``; K1 in the
    prefill, K7 in every decode step on ``int8`` weights), timed as a
    differential of two generation lengths so the prefill and the
    fixed per-call cost cancel.  Reports tokens/s and ms/token for a
    GQA config (the 154M by default).  ``int8`` generates on
    ``quantize_params`` weights; ``kv_int8`` stores the KV cache int8.
    Every timed call generates from a fresh prompt.
    """
    from ..models import greedy_generate, init_params, quantize_params
    from ..models.quant import _leaves

    device = resolve_device(device)
    cfg = _probe_config(32000, d_model, n_layers, heads, kv_heads, d_ff,
                        max_seq,
                        kv_cache_dtype="int8" if kv_int8 else "model")
    params = init_params(cfg, device=device)
    n_params = sum(t.numel() for t in _leaves(params))
    if int8:
        params = quantize_params(params, cfg)
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                           generator=gen).to(device)
    short = max(n_tokens // 4, 1)

    def make(n):
        @torch.no_grad()
        def run(p):
            return greedy_generate(params, p % cfg.vocab, cfg, n)[-1, -1]
        return run

    # Physical floor: every decode step re-streams all non-embedding
    # weights (the embedding is gathered, not read in full) AND the
    # full static KV cache (the masked read covers every slot), so a
    # per-token time implying more than 1.2x the memory peak over those
    # bytes is an artifact: reject and retry.
    w_itemsize = 1 if int8 else cfg.dtype.itemsize
    weight_bytes = (n_params - cfg.vocab * d_model) * w_itemsize
    c_itemsize = 1 if kv_int8 else cfg.dtype.itemsize
    cache_bytes = (2 * batch * max_seq * kv_heads
                   * (d_model // heads) * c_itemsize * n_layers)
    streamed = weight_bytes + cache_bytes
    on_accel = device.type == "cuda"
    floor_s = (streamed / (_DECODE_HBM_GBPS_CEILING * 1e9)
               if on_accel else 0.0)
    per_tok, valid = None, False
    for _ in range(5):
        per_tok, valid, _ = _differential_median(
            make(n_tokens), make(short), prompt, n_tokens, short,
            trials=reps)
        if valid and per_tok < floor_s:
            valid = False
        if valid:
            break
    return {
        "batch": batch, "layers": n_layers, "d_model": d_model,
        "heads": heads, "kv_heads": kv_heads, "int8": int8,
        "kv_int8": kv_int8,
        "params_m": round(n_params / 1e6, 1),
        "prompt_len": prompt_len, "n_tokens": n_tokens,
        "ms_per_token": per_tok * 1000,
        "tokens_per_s": batch / per_tok,
        "streamed_mb_per_token": round(streamed / 1e6, 1),
        "implied_gbps": round(streamed / per_tok / 1e9, 1),
        "valid": valid,
    }


def serving_probe(slots: int = 8, n_requests: int = 24,
                  n_layers: int = 8, d_model: int = 1024,
                  heads: int = 16, kv_heads: int = 4, d_ff: int = 4096,
                  prompt_len: int = 96, max_new: int = 48,
                  max_seq: int = 2048, seed: int = 0,
                  prefix_cache: int = 0,
                  shared_prefix: int = 0,
                  chain_steps: int = 1, device="cuda") -> dict:
    """Continuous-batching throughput (``models/serving.py``):
    mixed-length requests drained through a fixed-slot engine; reports
    decode tokens/s over the whole drain.

    Wall-clock (not differential) timing: the engine's host loop IS
    part of the serving path being measured, so the figure is a LOWER
    bound with the per-step wall alongside; the decode path's ceiling
    is :func:`decode_probe`'s differential number.  A warm-up engine at
    the measured slot count drains one request per distinct prompt
    length (two with a prefix cache) first, so first-use costs stay out
    of the timed drain.  On the card with ``chain_steps`` > 1 the
    measured engine itself drains the measured mix first instead: its
    CUDA graphs (one a block length, bound to the engine) are captured
    there, not in the timed drain.

    ``shared_prefix`` > 0 makes every prompt share that many leading
    tokens, with four distinct tail lengths, and ``prefix_cache`` sizes
    the engine's prefix cache (hit and reuse counters in the result).
    ``chain_steps=K`` drains through fused blocks of K decode steps
    (identical outputs).  The engine's per-phase walls and the
    dispatch counter's launches and readbacks a token are reported.
    """
    from ..models import init_params
    from ..models.serving import Request, ServingEngine
    from ..utils import dispatch as _dispatch

    device = resolve_device(device)
    cfg = _probe_config(32000, d_model, n_layers, heads, kv_heads, d_ff,
                        max_seq)
    params = init_params(cfg, device=device)
    rng = np.random.default_rng(seed)
    if shared_prefix:
        # keep four DISTINCT length classes in the tails so the drain
        # stays mixed-length (the floor keeps every tail >= 1 token)
        tb = max(prompt_len - shared_prefix, 8)   # floor: tails >= 2
        lengths = [tb, tb // 2, tb * 3 // 4, tb // 4]
        pre = rng.integers(0, cfg.vocab, shared_prefix)
    else:
        lengths = [prompt_len, prompt_len // 2, prompt_len * 3 // 4,
                   prompt_len // 4]
        pre = None

    def one_prompt(i):
        part = rng.integers(0, cfg.vocab, lengths[i % len(lengths)])
        return part if pre is None else np.concatenate([pre, part])

    def requests(tag):
        return [Request(uid=f"{tag}{i}", prompt=one_prompt(i),
                        max_new=max_new)
                for i in range(n_requests)]

    def engine():
        return ServingEngine(params, cfg, slots=slots,
                             prefix_cache=prefix_cache,
                             chain_steps=chain_steps, device=device)

    if device.type == "cuda" and chain_steps > 1:
        # a fused engine captures one CUDA graph per block length at its
        # first use, and the graphs are the engine's own (bound to its
        # cache): the warm-up drains the measured mix through the
        # measured engine itself, so every capture stays out of the
        # timed drain (its prefix cache, when on, is warm too)
        eng = engine()
        for req in requests("w"):
            eng.submit(req)
        eng.run()
    else:
        warm = engine()
        for i in range(2 * len(lengths)):
            warm.submit(Request(uid=f"w{i}", prompt=one_prompt(i),
                                max_new=2))
        warm.run()
        del warm     # its [slots, max_seq] cache must not share device
                     # memory with the measured engine
        eng = engine()

    reqs = requests("r")
    prompt_len_of = {r.uid: len(r.prompt) for r in reqs}
    for req in reqs:
        eng.submit(req)
    # the engine's counters are cumulative: the timed drain's are the
    # change over it (a warmed engine has counted its warm-up)
    before = eng.stats()
    t0 = time.perf_counter()
    with _dispatch.track() as disp:
        done = eng.run()
    wall = time.perf_counter() - t0
    after = eng.stats()
    stats = {k: (round(after[k] - before[k], 4)
                 if isinstance(after[k], float) else after[k] - before[k])
             for k in ("time_prefill_s", "time_decode_dispatch_s",
                       "time_host_s", "prefix_hits_total",
                       "prefix_tokens_reused_total") if k in after}
    generated = sum(len(f.tokens) - prompt_len_of[f.uid]
                    for f in done)
    # each request's FIRST token comes from its prefill argmax, so
    # decode steps emit max_new-1 tokens per request
    # min decode steps (>=1: max_new=1 drains with prefills alone)
    steps = max(-(-n_requests * (max_new - 1) // slots), 1)
    out = {
        "slots": slots,
        "requests": n_requests,
        "generated_tokens": int(generated),
        "wall_s": round(wall, 3),
        "tokens_per_s_lower_bound": round(generated / wall, 1),
        "per_step_ms_upper_bound": round(wall / steps * 1000, 3),
        # per-phase host accounting: engine overhead vs dispatch
        "prefill_s": stats["time_prefill_s"],
        "decode_dispatch_s": stats["time_decode_dispatch_s"],
        "host_s": stats["time_host_s"],
        # host dispatch accounting (utils/dispatch.py): launches and
        # blocking readbacks the drain paid per generated token
        "host_dispatches": disp.dispatches,
        "host_readbacks": disp.readbacks,
        "dispatches_per_token": round(
            disp.dispatches / max(int(generated), 1), 3),
        "valid": len(done) == n_requests,
    }
    if chain_steps > 1:
        out["chain_steps"] = chain_steps
        out["tokens_per_s"] = round(generated / wall, 1)
        out["note"] = (
            f"chained drain: {chain_steps} decode steps per block, "
            "each a CUDA-graph replay on the card (identical outputs); "
            "engine-throughput evidence; ceiling remains "
            "decode_probe's differential number")
    else:
        out["note"] = (
            "wall-clock drain incl. host scheduling and per-step "
            "launches (a throughput LOWER bound; the decode ceiling is "
            "decode_probe's differential number)")
    if shared_prefix:
        out["shared_prefix"] = shared_prefix
    if prefix_cache:
        out["prefix_hits"] = stats["prefix_hits_total"]
        out["prefix_tokens_reused"] = stats["prefix_tokens_reused_total"]
    return out


def dispatch_probe(slots: int = 2, n_requests: int = 4,
                   max_new: int = 12, chain_steps: int = 8,
                   n_layers: int = 2, d_model: int = 256,
                   heads: int = 4, kv_heads: int = 2, d_ff: int = 256,
                   prompt_len: int = 12, max_seq: int = 64,
                   rtt_samples: int = 30, device="cuda") -> dict:
    """Dispatch-overhead probe: ms per host dispatch and dispatches per
    generated token, per-step against fused engine
    (``utils/dispatch.py``).

    - ``ms_per_dispatch``: median round trip of one trivial device op
      synced by a scalar readback: the fixed per-launch cost every
      un-fused engine step pays.
    - ``per_step_dispatches_per_token`` against
      ``fused_dispatches_per_token``: the SAME tiny drain through the
      per-step and fused (``chain_steps=K``) engines, counted by the
      dispatch counter: hardware-independent numbers, equal to the
      JAX engine's at the same widths.

    The default ``d_model`` is 256 (heads of 64): the reference's 128
    over 4 heads gives heads of 32, which the card's K1 refuses.
    """
    from ..models import init_params
    from ..models.serving import Request, ServingEngine
    from ..utils import dispatch as _dispatch

    device = resolve_device(device)

    def f(x):
        return x + 1.0

    float(f(torch.zeros((), device=device)))          # warm
    rtts = []
    for i in range(rtt_samples):
        t0 = time.perf_counter()
        float(f(torch.tensor(float(i + 1), device=device)))
        rtts.append(time.perf_counter() - t0)
    ms_per_dispatch = statistics.median(rtts) * 1000

    cfg = _probe_config(4096, d_model, n_layers, heads, kv_heads, d_ff,
                        max_seq)
    params = init_params(cfg, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, prompt_len)
               for _ in range(n_requests)]

    def drain(k: int) -> tuple[float, int]:
        eng = ServingEngine(params, cfg, slots=slots, chain_steps=k,
                            device=device)
        for i, pr in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=pr, max_new=max_new))
        with _dispatch.track() as t:
            done = eng.run()
        generated = sum(len(f_.tokens) - prompt_len for f_ in done)
        return t.dispatches / max(generated, 1), t.readbacks

    per_step, per_step_rb = drain(1)
    fused, fused_rb = drain(chain_steps)
    ratio = per_step / max(fused, 1e-9)
    return {
        "ms_per_dispatch": round(ms_per_dispatch, 4),
        "rtt_samples": rtt_samples,
        "chain_steps": chain_steps,
        "per_step_dispatches_per_token": round(per_step, 3),
        "fused_dispatches_per_token": round(fused, 3),
        "per_step_readbacks": per_step_rb,
        "fused_readbacks": fused_rb,
        "dispatch_amortization_x": round(ratio, 2),
        "valid": ratio > 1.0,
    }


__all__ = ["allreduce_bandwidth", "attention_grad_probe",
           "attention_probe", "decode_probe", "dispatch_probe",
           "matmul_tflops", "measure_chain", "measure_chain_samples",
           "serving_probe"]
