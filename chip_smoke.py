"""On-card smoke test of the PyTorch/CUDA port (k8s_dra_driver_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper
card:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: require CUDA, print the card's name and power limit, turn
   TF32 off;
2. build the CUDA kernels from ``k8s_dra_driver_tpu_torch/csrc`` with
   nvcc (sm_90a) and print the build time;
3. K1 (flash-attention forward) against its plain PyTorch version at
   the serving path's shapes, with timings and the card's bound;
4. K2 (paged decode) likewise;
5. the serving engine, contiguous KV, at the full width of the 154M
   serving configuration (vocab 32000, d_model 1024, 8 layers, 16
   heads, 4 KV heads, d_ff 4096, max_seq 2048, bf16, random weights
   from a fixed generator) draining the s8_r24 traffic (8 slots, 24
   requests, prompt lengths 96/48/72/24, max_new 48, four of them
   sampled); every greedy stream is held to a teacher-forced pass of
   ``forward``;
6. the same with the paged KV layout and the paged kernel, then once
   more on a pool small enough to force preemption;
7. each kernel's device time at its main-path shape and at a long
   context (torch.profiler), after the drains so that profiling cannot
   tax them;
8. one JSON line naming every kernel with its launches on the main
   path, its error against the plain version and its times;
9. last line: ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# bf16 outputs are rounded to 8 mantissa bits (relative 2^-8, about
# 0.004 at |x| <= 1) and the kernel sums in another order than the
# plain version; f32 differs only by summation order and expf.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-3
# teacher-forced check: each greedy token's logit in one full-sequence
# forward pass must be within this of that position's max.  bf16 decode
# (stepwise cache reads) and the full forward round differently; with
# random weights the top two logits are often ~0.2 apart.
TF_MARGIN = 0.1

H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn()`` between CUDA events around
    ``iters`` back-to-back calls: device time, plus any gaps where the
    device waited for the host to enqueue the next call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float | None:
    """Device time per call of ``fn()``: the summed time of every kernel
    it runs (torch.profiler over CUPTI), host gaps excluded.  None when
    the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else None


def fmt(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    return torch.cuda.get_device_name(0)


def phase_build(build) -> None:
    t0 = time.perf_counter()
    build.library()
    took = time.perf_counter() - t0
    print(f"build: {took:.2f} s (nvcc: {build.build_seconds}) log "
          f"{build.build_log}", flush=True)
    print(build.build_log.read_text()[-3000:], flush=True)


def sdpa_fn(q, k, v, causal):
    """One PyTorch call computing the same attention (yardstick only,
    never called by the port)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    group = q.shape[2] // k.shape[2]
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=group > 1)
    kt = kt.repeat_interleave(group, dim=1)
    vt = vt.repeat_interleave(group, dim=1)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)


def flash_bound(b, t, h, h_kv, d, window, seg, dtype) -> tuple[float, str]:
    """Least time for one forward: inputs read once, outputs written
    once, over the memory rate; the valid (q, k) pairs' 4*D flops over
    the peak rate of the inputs' type; the larger of the two."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * t * (2 * h + 2 * h_kv) * d * es + b * h * t * 4
              + (b * t * 4 if seg is not None else 0))
    qpos = np.arange(t)[:, None]
    kpos = np.arange(t)[None]
    valid = kpos <= qpos
    if window:
        valid &= qpos - kpos < window
    pairs = 0
    if seg is not None:
        for row in seg.cpu().numpy():
            pairs += int((valid & (row[:, None] == row[None])).sum())
        pairs *= h
    else:
        pairs = b * h * int(valid.sum())
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_b, t_f = nbytes / H100_BYTES_PER_S, 4 * d * pairs / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def phase_flash(fa) -> dict:
    """K1 against its plain version; returns the kernels-line row at
    the largest prefill call of the s8_r24 contiguous drain (B=2
    T=96), and, by shape, callables of the kernel, its plain version
    and the library call at that shape and at B=8 T=2048."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for b in (1, 2, 8):
        for t in (24, 48, 72, 96, 2048):
            if b == 2 and t == 2048:
                continue
            cases.append(dict(b=b, t=t, d=64, window=None, seg=False,
                              dtype=torch.bfloat16))
    cases += [
        dict(b=8, t=2048, d=64, window=256, seg=False,
             dtype=torch.bfloat16),
        dict(b=8, t=96, d=64, window=None, seg=True, dtype=torch.bfloat16),
        dict(b=2, t=2048, d=64, window=256, seg=True,
             dtype=torch.bfloat16),
        dict(b=2, t=96, d=128, window=None, seg=False,
             dtype=torch.bfloat16),
        dict(b=1, t=96, d=64, window=None, seg=True, dtype=torch.float32),
        dict(b=1, t=2048, d=128, window=32, seg=False,
             dtype=torch.float32),
    ]
    row, probes = None, {}
    for c in cases:
        b, t, d, dtype = c["b"], c["t"], c["d"], c["dtype"]
        h, h_kv = 16, 4
        q = torch.randn((b, t, h, d), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        k = torch.randn((b, t, h_kv, d), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        v = torch.randn((b, t, h_kv, d), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        seg = None
        if c["seg"]:
            cuts = torch.randint(0, 4, (b, t), generator=gen, device=dev)
            seg = (torch.cumsum((cuts == 0).to(torch.int32), dim=1)
                   .to(torch.int32).contiguous())
        kw = dict(causal=True, window=c["window"], segment_ids=seg)
        out, lse = fa.flash_forward(q, k, v, **kw)
        ref, ref_lse = fa.flash_forward_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"K1 non-finite output at {c}")
        err = (out.float() - ref.float()).abs().max().item()
        lerr = (lse - ref_lse).abs().max().item()
        ms = cuda_ms(lambda: fa.flash_forward(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: fa.flash_forward_reference(q, k, v,
                                                              **kw),
                           iters=5)
        lib_ms = None
        if seg is None and c["window"] is None:
            lib_ms = cuda_ms(sdpa_fn(q, k, v, True))
        bound, by = flash_bound(b, t, h, h_kv, d, c["window"], seg,
                                dtype)
        ok = err <= TOL[dtype] and lerr <= LSE_TOL
        print(f"K1 B={b} T={t} H={h} Hkv={h_kv} D={d} "
              f"window={c['window']} seg={seg is not None} "
              f"{str(dtype).removeprefix('torch.')}: max|d|={err:.3g} "
              f"(tol {TOL[dtype]}) lse max|d|={lerr:.3g} kernel_ms="
              f"{ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{fmt(lib_ms)} bound_us={bound * 1e3:.2f} ({by}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K1 disagrees with its plain version at {c}")
        plain_causal = (d == 64 and seg is None and c["window"] is None
                        and dtype == torch.bfloat16)
        if plain_causal and (b, t) in ((2, 96), (8, 2048)):
            main = " (main path)" if (b, t) == (2, 96) else ""
            probes[f"B={b} T={t}{main}"] = dict(
                kernel=lambda q=q, k=k, v=v: fa.flash_forward(q, k, v),
                plain=lambda q=q, k=k, v=v: fa.flash_forward_reference(
                    q, k, v),
                library=sdpa_fn(q, k, v, True))
        if plain_causal and (b, t) == (2, 96):
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=lib_ms)
    return row, probes


def paged_bound(lengths, b, h, h_kv, d, es) -> tuple[float, str]:
    """Least time for one paged step: the valid K/V rows plus q, out,
    tables and lengths over the memory rate, against 4*D flops per
    (head, valid key) over the bf16 peak."""
    kv_bytes = 2 * int(sum(lengths)) * h_kv * d * es
    nbytes = kv_bytes + 2 * b * h * d * es + 8 * b
    flops = 4 * d * h * int(sum(lengths))
    t_b, t_f = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def phase_paged(pa) -> dict:
    """K2 against its plain version; returns the kernels-line row at a
    mid-drain decode step of the s8_r24 paged engine (lengths
    120/72/96/48), and, by shape, callables of the kernel and its plain
    version at that step and at eight 2048-token rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(2)
    b, h, h_kv, d, bs = 8, 16, 4, 64, 16
    n_pages = 2048 // bs
    row, probes = None, {}
    cases = [
        ([1, 17, 96, 2048, 1, 17, 96, 2048], 64, torch.bfloat16),
        ([120, 72, 96, 48, 120, 72, 96, 48], 64, torch.bfloat16),
        ([2048] * 8, 64, torch.bfloat16),
        ([1, 17, 96, 2048, 5, 33, 300, 1000], 128, torch.bfloat16),
        ([1, 17, 96, 2048, 5, 33, 300, 1000], 64, torch.float32),
    ]
    for lengths, d, dtype in cases:
        n_blocks = b * n_pages + 1
        k_pool = torch.randn((n_blocks, bs, h_kv, d), generator=gen,
                             device=dev).to(dtype)
        v_pool = torch.randn((n_blocks, bs, h_kv, d), generator=gen,
                             device=dev).to(dtype)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
        # shuffled, non-contiguous block tables; unused slots -> null 0
        perm = rng.permutation(np.arange(1, n_blocks))
        tables = np.zeros((b, n_pages), np.int32)
        for i, length in enumerate(lengths):
            need = -(-length // bs)
            tables[i, :need] = perm[i * n_pages:i * n_pages + need]
        tables = torch.as_tensor(tables, device=dev)
        lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        out = pa.paged_attention(q, k_pool, v_pool, tables, lens)
        ref = pa.paged_attention_reference(q, k_pool, v_pool, tables,
                                           lens)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: pa.paged_attention(q, k_pool, v_pool,
                                                tables, lens))
        plain_ms = cuda_ms(lambda: pa.paged_attention_reference(
            q, k_pool, v_pool, tables, lens), iters=5)
        es = torch.tensor([], dtype=dtype).element_size()
        bound, by = paged_bound(lengths, b, h, h_kv, d, es)
        ok = bool(torch.isfinite(out.float()).all()) and err <= TOL[dtype]
        print(f"K2 B={b} H={h} Hkv={h_kv} D={d} bs={bs} "
              f"lengths={lengths} {str(dtype).removeprefix('torch.')}: "
              f"max|d|={err:.3g} (tol {TOL[dtype]}) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms=None "
              f"bound_us={bound * 1e3:.2f} ({by}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K2 disagrees with its plain version at {lengths}")
        if d == 64 and dtype == torch.bfloat16 and lengths[0] in (120,
                                                                 2048):
            args = (q, k_pool, v_pool, tables, lens)
            main = " (main path)" if lengths[0] == 120 else ""
            probes[f"lengths {lengths[:4]}x2{main}"] = dict(
                kernel=lambda a=args: pa.paged_attention(*a),
                plain=lambda a=args: pa.paged_attention_reference(*a))
        if lengths[0] == 120 and d == 64:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=None)
    return row, probes


def serving_model():
    """(cfg, params): the 154M serving configuration at full width and
    depth in bf16, random weights from generator seed 0 on the card."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        TransformerConfig, init_params)
    cfg = TransformerConfig(vocab=32000, d_model=1024, n_layers=8,
                            n_heads=16, n_kv_heads=4, d_head=64,
                            d_ff=4096, max_seq=2048, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    n_params = sum(p.numel() for p in [params["embed"], params["unembed"],
                                       params["ln_f"]]
                   + [t for layer in params["layers"]
                      for t in layer.values()])
    print(f"model: 154M serving config, {n_params} parameters, bf16",
          flush=True)
    return cfg, params


def s8_r24(vocab: int):
    """The bench's s8_r24 drain: 24 requests, prompt lengths cycling
    96/48/72/24 from numpy seed 0, max_new 48; requests 3, 9, 15 and 21
    are sampled (temperature 0.8, engine top_k 50)."""
    from k8s_dra_driver_tpu_torch.models.serving import Request
    rng = np.random.default_rng(0)
    lengths = [96, 48, 72, 24]
    reqs = []
    for i in range(24):
        prompt = rng.integers(0, vocab, lengths[i % 4]).astype(np.int32)
        sampled = i % 6 == 3
        reqs.append(Request(uid=f"r{i}", prompt=prompt, max_new=48,
                            temperature=0.8 if sampled else 0.0,
                            seed=100 + i))
    return reqs


def teacher_forced(params, cfg, finished, reqs) -> float:
    """Every greedy stream: one forward over prompt + generated tokens;
    each generated token's logit must be within TF_MARGIN of that
    position's max.  Returns the worst gap seen."""
    from k8s_dra_driver_tpu_torch.models.transformer import forward
    by_uid = {r.uid: r for r in reqs}
    worst = 0.0
    with torch.no_grad():
        for f in finished:
            req = by_uid[f.uid]
            if len(f.tokens) != len(req.prompt) + req.max_new:
                fail(f"{f.uid}: {len(f.tokens)} tokens, expected "
                     f"{len(req.prompt) + req.max_new}")
            toks = torch.as_tensor(f.tokens, dtype=torch.long,
                                   device=params["embed"].device)
            if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
                fail(f"{f.uid}: token out of range")
            if req.temperature > 0:
                continue
            logits = forward(params, toks[None], cfg)[0].float()
            if not torch.isfinite(logits).all():
                fail(f"{f.uid}: non-finite logits")
            n = f.n_prompt
            pred = logits[n - 1:-1]
            gen = toks[n:]
            gap = (pred.max(dim=-1).values
                   - pred.gather(1, gen[:, None])[:, 0])
            worst = max(worst, float(gap.max()))
    if worst > TF_MARGIN:
        fail(f"teacher-forced check: a greedy token's logit is "
             f"{worst:.3f} below its position's max (margin "
             f"{TF_MARGIN})")
    return worst


def drain(engine_cls, params, cfg, reqs, fa, pa, label, **kw):
    """Drive one engine over ``reqs`` with the kernel counters zeroed
    just before and read just after; returns (finished, counts,
    stats)."""
    warm = engine_cls(params, cfg, slots=8, **kw)
    for r in reqs[:2]:
        warm.submit(type(r)(uid="w" + r.uid, prompt=r.prompt, max_new=2))
    warm.run()
    del warm
    eng = engine_cls(params, cfg, slots=8, **kw)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    fa.launches = 0
    pa.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"flash_fwd": fa.launches, "paged_decode": pa.launches}
    stats = eng.stats()
    gen_tokens = sum(len(f.tokens) - f.n_prompt for f in done)
    if len(done) != len(reqs):
        fail(f"{label}: {len(done)} of {len(reqs)} requests finished")
    print(f"engine {label}: {len(done)} finished, {gen_tokens} tokens in "
          f"{wall:.3f} s = {gen_tokens / wall:.1f} tokens/s, "
          f"{1e3 * wall / max(stats['decode_steps_total'], 1):.3f} ms "
          f"per decode step (wall), kernel launches {counts}",
          flush=True)
    print(f"engine {label} stats: {json.dumps(stats)}", flush=True)
    return done, counts, stats


def main() -> None:
    kind = phase_device()
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.ops import _build
    from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
    from k8s_dra_driver_tpu_torch.ops import paged_attention as pa

    phase_build(_build)
    k1, k1_probes = phase_flash(fa)
    k2, k2_probes = phase_paged(pa)

    cfg, params = serving_model()
    reqs = s8_r24(cfg.vocab)
    launches = {"flash_fwd": 0, "paged_decode": 0}

    done_c, counts, _ = drain(ServingEngine, params, cfg, reqs, fa, pa,
                              "contiguous", top_k=50)
    if counts["flash_fwd"] <= 0:
        fail("contiguous drain launched no flash kernel")
    worst = teacher_forced(params, cfg, done_c, reqs)
    print(f"teacher-forced (contiguous): worst gap {worst:.4f} <= "
          f"{TF_MARGIN}", flush=True)
    for name in launches:
        launches[name] += counts[name]

    done_p, counts, _ = drain(ServingEngine, params, cfg, reqs, fa, pa,
                              "paged", top_k=50, kv_layout="paged")
    if counts["flash_fwd"] <= 0 or counts["paged_decode"] <= 0:
        fail(f"paged drain kernel launches {counts}: both must be > 0")
    worst = teacher_forced(params, cfg, done_p, reqs)
    print(f"teacher-forced (paged): worst gap {worst:.4f} <= "
          f"{TF_MARGIN}", flush=True)
    for name in launches:
        launches[name] += counts[name]
    same = sum(np.array_equal(a.tokens, b.tokens) for a, b in zip(
        sorted(done_c, key=lambda f: f.uid),
        sorted(done_p, key=lambda f: f.uid)))
    print(f"paged vs contiguous: {same}/24 streams identical (bf16 "
          f"kernel and plain reads may part after near ties)", flush=True)

    done_x, counts, stats = drain(
        ServingEngine, params, cfg, reqs, fa, pa, "paged-preempt",
        top_k=50, kv_layout="paged", max_seq=256, kv_blocks=41)
    if stats["kv_preemptions_total"] < 1:
        fail("the shrunken pool forced no preemption")
    if counts["paged_decode"] <= 0:
        fail("preemption drain launched no paged kernel")
    worst = teacher_forced(params, cfg, done_x, reqs)
    print(f"teacher-forced (paged, {stats['kv_preemptions_total']} "
          f"preemptions): worst gap {worst:.4f} <= {TF_MARGIN}",
          flush=True)
    for name in launches:
        launches[name] += counts[name]

    # device time at the main-path shape and at a long context,
    # profiled last: profiling before the drains would tax their every
    # launch
    for name, row, by_shape in (("K1", k1, k1_probes),
                                ("K2", k2, k2_probes)):
        for shape, probes in by_shape.items():
            times = {what: device_ms(fn) for what, fn in probes.items()}
            if shape.endswith("(main path)"):
                row["device_ms"] = times["kernel"]
            print(f"{name} device_ms at {shape} (kernels only, host gaps "
                  f"excluded): "
                  + " ".join(f"{w}={fmt(t)}" for w, t in times.items()),
                  flush=True)

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/flash_fwd.cu",
             replaces="k8s_dra_driver_tpu/ops/flash_attention.py:122",
             launches=launches["flash_fwd"], **k1),
        dict(name="paged_decode", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/paged_decode.cu",
             replaces="k8s_dra_driver_tpu/ops/paged_attention.py:125",
             launches=launches["paged_decode"], **k2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
