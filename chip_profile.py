"""Where a serving drain's and a training step's time goes on the card.

Run from the root of a checkout on a machine with one NVIDIA Hopper
card, after ``chip_smoke.py`` has shown the port is right there:

    python3 chip_profile.py

Same model and traffic as ``chip_smoke.py``: the 154M serving
configuration in bf16 with random weights, and the s8_r24 drain.  For
each KV layout (contiguous; paged with the paged kernel) it

1. drains the traffic once to warm up, once on the host clock, and
   once under ``torch.profiler`` with device activity only (the
   profiler records each kernel, copy and memset the card ran, and
   the host's CUDA runtime calls);
2. fills 8 slots with 96-token prompts and times a window of pure
   decode steps, then profiles another window of the same length,
   split by kernel kind (K1, K2 on the paged layout, the rest).

It prints, per layout, the wall time, the device's busy time (the sum
of every device op's time in the profiled run) and the busy share
(busy time over the unprofiled run's wall time), the device ops
launched per decode step, and the ops with the most device time.

Then the training step of ``chip_smoke.py``'s training phase (the same
configuration, B=8 x T=2048, AdamW): two warm-up steps, TRAIN_WINDOW
steps on the host clock, TRAIN_WINDOW more under the profiler; per
step its wall time, device busy time and share, and the device time of
the flash kernels (K1, K3, K4), the matrix products, the optimizer and
everything else.  Then the same for one moe_heavy training step with
gmm dispatch (``chip_smoke.py``'s MoE phase: 16 experts, top_k 2,
B=8 x T=1024), split further into the grouped-matmul kernels K5 and K6
and the routing (sorts, counts, index scatters and gathers).  Then the
elastic gang's step (``chip_smoke.py``'s ``phase_gang_recovery``: the
154M at B=8 x T=2048 as ``ElasticTrainJob(chips=4)`` rows, each row its
own forward and backward, f32 gradient sums, one AdamW step) at dp=4
and dp=2, split the same way.

Then int8 serving: the 154M weights through ``quantize_params``, the
steady decode window of each KV layout on them (device ms split into
K7, the attention kernels and the rest, and the busy share), and the
contiguous window once more on the einsum route K7 displaces; and the
660M configuration of ``tools/bench_int8.py`` (12 layers, d_model 2048,
16 heads, 4 KV heads, d_ff 8192, vocab 32000, bf16, random weights) in
a steady decode window of 8 rows, bf16 weights against int8 weights,
each beside the least time its weight bytes take at the card's memory
rate.  Last, the fused generation block: 8 slots decoding in blocks of
``chip_smoke.FUSED_CHAIN`` (47) steps, each one replay of a captured
CUDA graph, on the 154M's bf16 and int8 weights: wall and device ms
per generated token and per step, and the busy share, beside the eager
steady window of the same weights; then the same window with
speculation inside the blocks (``draft_len`` 4, the n-gram source and
the target as its own draft, bf16 weights, every row live): wall and
device ms a window and a token, tokens a row a window, the busy share
and the device time by kind.  Last, multi-adapter LoRA: the steady
window once more with the 8 rows on 8 distinct rank-16 adapters (an
8-slot pool, all resident), eager and in fused blocks, beside the
adapter-less window of the same form: the device ms a step the
adapters' gathers and low-rank products add, by kind.  Measurement
only: no gate, no claim.

The last line is one JSON object with those numbers.  Exits non-zero
without a card.  Imports nothing of JAX and nothing of the JAX
package.
"""

from __future__ import annotations

import json
import time
from unittest import mock

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke

WINDOW = 32      # decode steps per steady-state window
FUSED_BLOCKS = 2  # fused blocks (of smoke.FUSED_CHAIN steps) per window
TRAIN_WINDOW = 3  # training steps timed, then as many profiled
TOP = 10         # device ops listed per run

# device ops by kind, matched on the kernel's name in this order
KINDS = (
    # both routes of K1, K5 and K6, as of K3 and K4 below: tensor cores
    # (bf16, the *_sm90_kernel names) and CUDA cores (f32)
    ("K1 flash_fwd", ("flash_fwd_kernel", "flash_fwd_sm90_kernel")),
    # K2 is one kernel since its split redesign: the merge of a row's
    # splits runs in the same launch (its last-arriving block)
    ("K2 paged_decode", ("paged_decode_kernel",)),
    # both routes of K7 share one kernel name; its split-K second pass
    ("K7 int8_matmul", ("int8_matmul_sm90_kernel",
                        "int8_splitk_sum_kernel")),
    # both routes: tensor cores (bf16, the *_sm90_kernel names) and
    # CUDA cores (f32)
    ("K3 flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_sm90_kernel")),
    ("K4 flash_bwd_dkv", ("flash_bwd_dkv_kernel",
                          "flash_bwd_dkv_sm90_kernel")),
    ("K6 gmm_dw", ("gmm_dw_kernel", "gmm_dw_sm90_kernel")),
    ("K5 gmm", ("gmm_kernel", "gmm_sm90_kernel")),
    ("matrix products", ("gemm", "Gemm", "xmma", "cutlass", "nvjet")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    # the MoE dispatch: argsort, the per-expert counts, the cumulative
    # offsets and block search, and the row maps' index scatters and
    # gathers with their backward (the embedding's row gather lands
    # here too)
    ("routing (sort, counts, scatters, gathers)",
     ("sort", "Sort", "scatter", "index", "gather", "searchsorted",
      "scan", "Scan")),
)


def device_summary(prof) -> dict:
    """Busy time, op count and the heaviest ops of one profiled run:
    every averaged event with device time is a device op (kernel,
    copy, memset); host runtime calls carry none."""
    ops = [e for e in prof.key_averages()
           if getattr(e, "self_device_time_total", 0.0) > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return {
        "busy_ms": sum(e.self_device_time_total for e in ops) / 1e3,
        "device_ops": sum(e.count for e in ops),
        "top": [{"op": e.key[:100], "count": e.count,
                 "ms": e.self_device_time_total / 1e3} for e in ops[:TOP]],
    }


def profiled(fn) -> dict:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    summary = device_summary(prof)
    if summary["busy_ms"] <= 0:
        smoke.fail("the profiler recorded no device time")
    summary["ms_by_kind"] = by_kind(prof)
    return summary


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def drain_profile(make_engine, reqs) -> dict:
    """Warm-up, timed and profiled drains of ``reqs``, each on a fresh
    engine built outside the measured region."""
    def loaded():
        eng = make_engine()
        for r in reqs:
            eng.submit(r)
        return eng

    loaded().run()
    eng = loaded()
    wall_s = timed(eng.run)
    steps = eng.stats()["decode_steps_total"]
    eng = loaded()
    summary = profiled(eng.run)
    wall_ms = wall_s * 1e3
    return {"wall_ms": wall_ms, "decode_steps": steps,
            "busy_share": summary["busy_ms"] / wall_ms, **summary}


def steady_profile(make_engine, request_cls, vocab: int,
                   adapters=(None,) * 8) -> dict:
    """Eight slots decoding, no fills: per-step wall time over WINDOW
    steps, then per-step device time and ops over WINDOW more.  Row i
    decodes with ``adapters[i]`` (None: the base model)."""
    eng = make_engine()
    rng = np.random.default_rng(1)
    for i in range(8):
        prompt = rng.integers(0, vocab, 96).astype(np.int32)
        eng.submit(request_cls(uid=f"s{i}", prompt=prompt,
                               max_new=2 * WINDOW + 16,
                               adapter=adapters[i]))
    for _ in range(5):       # the first step fills every slot
        eng.step()

    def window():
        for _ in range(WINDOW):
            if eng.step():
                raise RuntimeError("a slot finished inside the window")

    wall_ms = timed(window) * 1e3 / WINDOW
    summary = profiled(window)
    busy_ms = summary["busy_ms"] / WINDOW
    return {"step_wall_ms": wall_ms, "step_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "device_ops_per_step": summary["device_ops"] / WINDOW,
            "ms_by_kind": {k: v / WINDOW for k, v
                           in summary["ms_by_kind"].items() if v},
            "top": summary["top"]}


def fused_steady_profile(make_engine, request_cls, vocab: int,
                         adapters=(None,) * 8) -> dict:
    """Eight slots decoding in fused blocks of ``chain_steps`` steps, no
    fills: wall per generated token over FUSED_BLOCKS blocks, then
    device time per token over FUSED_BLOCKS more.  The first step fills
    every slot and the second runs the first block, capturing its graph
    before the window.  Row i decodes with ``adapters[i]``."""
    eng = make_engine()
    k = eng.chain_steps
    rng = np.random.default_rng(1)
    for i in range(8):
        prompt = rng.integers(0, vocab, 96).astype(np.int32)
        eng.submit(request_cls(uid=f"s{i}", prompt=prompt,
                               max_new=k * (2 * FUSED_BLOCKS + 1) + 16,
                               adapter=adapters[i]))
    for _ in range(2):
        eng.step()

    def window():
        for _ in range(FUSED_BLOCKS):
            if eng.step():
                raise RuntimeError("a slot finished inside the window")

    tokens = 8 * k * FUSED_BLOCKS
    wall_ms = timed(window) * 1e3
    summary = profiled(window)
    return {"chain_steps": k, "token_wall_ms": wall_ms / tokens,
            "token_busy_ms": summary["busy_ms"] / tokens,
            "step_wall_ms": wall_ms / (k * FUSED_BLOCKS),
            "step_busy_ms": summary["busy_ms"] / (k * FUSED_BLOCKS),
            "busy_share": summary["busy_ms"] / wall_ms,
            "device_ops_per_step": summary["device_ops"] / (k * FUSED_BLOCKS),
            "ms_by_kind": {kind: v / (k * FUSED_BLOCKS) for kind, v
                           in summary["ms_by_kind"].items() if v},
            "graphs": eng.stats()["graph_captures_total"],
            "top": summary["top"]}


def report_fused(label: str, fused: dict, eager: dict) -> None:
    """A fused window beside the eager steady window of the same
    weights (8 tokens a step)."""
    print(f"{label} fused steady decode (chain_steps="
          f"{fused['chain_steps']}): {fused['token_wall_ms']:.4f} ms wall "
          f"and {fused['token_busy_ms']:.4f} ms device per token "
          f"({fused['step_wall_ms']:.3f} / {fused['step_busy_ms']:.3f} ms "
          f"per step, busy {100 * fused['busy_share']:.1f}%, "
          f"{fused['device_ops_per_step']:.1f} device ops per step); eager: "
          f"{eager['step_wall_ms'] / 8:.4f} ms wall and "
          f"{eager['step_busy_ms'] / 8:.4f} ms device per token "
          f"({eager['step_wall_ms']:.3f} / {eager['step_busy_ms']:.3f} ms "
          f"per step, busy {100 * eager['busy_share']:.1f}%)", flush=True)
    for kind, ms in fused["ms_by_kind"].items():
        print(f"  {kind}: {ms:.4f} ms per step", flush=True)
    for row in fused["top"]:
        print(f"  {row['ms']:9.3f} ms {row['count']:6d}x {row['op']}",
              flush=True)


def spec_steady_profile(make_engine, request_cls, vocab: int) -> dict:
    """Eight slots decoding in fused speculative blocks, no fills and no
    row past its stop (so no frozen window): wall per window and per
    generated token over FUSED_BLOCKS blocks, then device time per
    window and per token over FUSED_BLOCKS more.  The first step fills
    every slot and the second runs the first block, capturing its
    graph before the window."""
    eng = make_engine()
    rng = np.random.default_rng(1)
    for i in range(8):
        prompt = rng.integers(0, vocab, 96).astype(np.int32)
        eng.submit(request_cls(uid=f"s{i}", prompt=prompt, max_new=1500))
    for _ in range(2):
        eng.step()

    def counts():
        st = eng.stats()
        return (sum(len(g) for g in eng._generated),
                st["speculative_windows_total"],
                st["speculative_accepted_total"],
                st["speculative_drafts_total"])

    def window():
        for _ in range(FUSED_BLOCKS):
            if eng.step():
                raise RuntimeError("a slot finished inside the window")

    c0 = counts()
    wall_ms = timed(window) * 1e3
    c1 = counts()
    summary = profiled(window)
    c2 = counts()
    tokens, windows = c1[0] - c0[0], c1[1] - c0[1]
    p_tokens, p_windows = c2[0] - c1[0], c2[1] - c1[1]
    return {"chain_steps": eng.chain_steps, "draft_len": eng.draft_len,
            "windows": windows, "tokens": tokens,
            "tokens_per_row_window": tokens / (8 * windows),
            "accept_rate": (c1[2] - c0[2]) / max(1, c1[3] - c0[3]),
            "window_wall_ms": wall_ms / windows,
            "window_busy_ms": summary["busy_ms"] / p_windows,
            "token_wall_ms": wall_ms / tokens,
            "token_busy_ms": summary["busy_ms"] / p_tokens,
            "busy_share": (summary["busy_ms"] / p_windows)
            / (wall_ms / windows),
            "device_ops_per_window": summary["device_ops"] / p_windows,
            "ms_by_kind": {kind: v / p_windows for kind, v
                           in summary["ms_by_kind"].items() if v},
            "top": summary["top"]}


def report_spec(label: str, spec: dict, fused: dict) -> None:
    """A fused speculative window beside the plain fused window of the
    same weights."""
    print(f"{label} fused speculative steady decode (chain_steps="
          f"{spec['chain_steps']}, draft_len {spec['draft_len']}): "
          f"{spec['window_wall_ms']:.3f} ms wall and "
          f"{spec['window_busy_ms']:.3f} ms device a window (busy "
          f"{100 * spec['busy_share']:.1f}%, "
          f"{spec['device_ops_per_window']:.1f} device ops a window), "
          f"{spec['tokens_per_row_window']:.3f} tokens a row a window "
          f"(accept rate {spec['accept_rate']:.4f}): "
          f"{spec['token_wall_ms']:.4f} ms wall and "
          f"{spec['token_busy_ms']:.4f} ms device per token; plain fused: "
          f"{fused['token_wall_ms']:.4f} / {fused['token_busy_ms']:.4f} ms "
          f"per token ({fused['step_busy_ms']:.3f} ms device a step)",
          flush=True)
    for kind, ms in spec["ms_by_kind"].items():
        print(f"  {kind}: {ms:.4f} ms a window", flush=True)
    for row in spec["top"]:
        print(f"  {row['ms']:9.3f} ms {row['count']:6d}x {row['op']}",
              flush=True)


def report_lora(label: str, lora: dict, plain: dict) -> None:
    """A steady window of 8 rows on 8 distinct adapters beside the
    adapter-less window of the same weights and form: the device ms a
    step the adapters' gathers and low-rank products add."""
    add = lora["step_busy_ms"] - plain["step_busy_ms"]
    print(f"{label} steady decode, 8 rows on 8 adapters (rank "
          f"{smoke.LORA_RANK}): {lora['step_wall_ms']:.3f} ms wall and "
          f"{lora['step_busy_ms']:.4f} ms device a step (busy "
          f"{100 * lora['busy_share']:.1f}%, "
          f"{lora['device_ops_per_step']:.1f} device ops a step); without "
          f"adapters {plain['step_wall_ms']:.3f} / "
          f"{plain['step_busy_ms']:.4f} ms "
          f"({plain['device_ops_per_step']:.1f} ops): the adapters add "
          f"{add:.4f} ms device a step "
          f"({100 * add / plain['step_busy_ms']:.1f}%) and "
          f"{lora['device_ops_per_step'] - plain['device_ops_per_step']:.1f}"
          f" device ops", flush=True)
    for kind, ms in lora["ms_by_kind"].items():
        print(f"  {kind}: {ms:.4f} ms per step (without adapters "
              f"{plain['ms_by_kind'].get(kind, 0.0):.4f})", flush=True)


def by_kind(prof) -> dict:
    """Device ms of one profiled run split by KINDS ("other": the rest:
    elementwise, reductions, copies, memsets)."""
    out = {name: 0.0 for name, _ in KINDS}
    out["other"] = 0.0
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3
        if ms <= 0:
            continue
        kind = next((name for name, keys in KINDS
                     if any(k in e.key for k in keys)), "other")
        out[kind] += ms
    return out


def train_profile(cfg=None, b: int = smoke.TRAIN_B,
                  t: int = smoke.TRAIN_T, dp: int | None = None) -> dict:
    """Wall and device time per full-width training step of ``cfg``
    (default the 154M configuration) at B=b x T=t; with ``dp``, the
    elastic gang's step over that many rows (``ElasticTrainJob``)."""
    from k8s_dra_driver_tpu_torch.models.transformer import make_train_step
    from k8s_dra_driver_tpu_torch.parallel.supervisor import (
        ElasticTrainJob)
    cfg = cfg or smoke.serving_config()
    if dp is None:
        step, init_state = make_train_step(cfg, device="cuda")
    else:
        job = ElasticTrainJob(cfg, np.zeros(b * t, np.int32), batch=b,
                              seq_len=t, chips=dp, tp=1, device="cuda")
        _, step, init_state = job.build(dp)
    params, opt = init_state(torch.Generator(device="cuda").manual_seed(0))
    motif = np.random.default_rng(0).integers(0, cfg.vocab, 32)
    batch = np.tile(motif, b * t // 32).reshape(b, t).astype(np.int32)
    state = [params, opt]

    def window():
        for _ in range(TRAIN_WINDOW):
            state[0], state[1], loss = step(state[0], state[1], batch)
            float(loss)                      # the step's end, as a user
    for _ in range(2):
        state[0], state[1], _ = step(state[0], state[1], batch)
    wall_ms = timed(window) * 1e3 / TRAIN_WINDOW
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    summary = device_summary(prof)
    kinds = {k: v / TRAIN_WINDOW for k, v in by_kind(prof).items()}
    busy_ms = summary["busy_ms"] / TRAIN_WINDOW
    return {"batch": b, "seq": t, "step_wall_ms": wall_ms,
            "step_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "tokens_per_s": b * t / (wall_ms / 1e3),
            "device_ops_per_step": summary["device_ops"] / TRAIN_WINDOW,
            "ms_by_kind": kinds, "top": summary["top"]}


def report_train(train: dict, label: str = "train step") -> None:
    print(f"{label} (B={train['batch']} T={train['seq']}): "
          f"{train['step_wall_ms']:.1f} ms wall, "
          f"{train['tokens_per_s']:.0f} tokens/s, "
          f"{train['step_busy_ms']:.1f} ms device busy "
          f"({100 * train['busy_share']:.1f}%), "
          f"{train['device_ops_per_step']:.0f} device ops per step",
          flush=True)
    for kind, ms in train["ms_by_kind"].items():
        print(f"  {ms:10.3f} ms/step {kind}", flush=True)
    print(f"{label}, top device ops:", flush=True)
    for row in train["top"]:
        print(f"  {row['ms']:10.3f} ms {row['count']:7d}x {row['op']}",
              flush=True)


def report(label: str, drain: dict, steady: dict) -> None:
    print(f"{label} drain: wall {drain['wall_ms']:.1f} ms, "
          f"{drain['decode_steps']} decode steps, device busy "
          f"{drain['busy_ms']:.1f} ms ({100 * drain['busy_share']:.1f}% "
          f"of the wall), {drain['device_ops']} device ops", flush=True)
    print(f"{label} steady decode: {steady['step_wall_ms']:.3f} ms wall "
          f"per step, {steady['step_busy_ms']:.3f} ms device busy "
          f"({100 * steady['busy_share']:.1f}%), "
          f"{steady['device_ops_per_step']:.1f} device ops per step",
          flush=True)
    for kind, ms in steady["ms_by_kind"].items():
        print(f"  {ms:10.4f} ms/step {kind}", flush=True)
    for what, rows in (("drain", drain["top"]),
                       ("steady window", steady["top"])):
        print(f"{label} {what}, top device ops:", flush=True)
        for row in rows:
            print(f"  {row['ms']:10.3f} ms {row['count']:7d}x "
                  f"{row['op']}", flush=True)


def config_660m():
    """``tools/bench_int8.py``'s 660M shape on ``decode_probe``'s
    defaults: vocab 32000, d_model 2048, 12 layers, 16 heads (d_head
    128), 4 KV heads, d_ff 8192, max_seq 1024, bf16."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        TransformerConfig)
    return TransformerConfig(vocab=32000, d_model=2048, n_layers=12,
                             n_heads=16, n_kv_heads=4, d_head=128,
                             d_ff=8192, max_seq=1024, dtype=torch.bfloat16)


def weight_bytes(params) -> int:
    """Bytes a decode step streams: every weight but the embedding table
    (gathered, a few rows a step), scales included."""
    from k8s_dra_driver_tpu_torch.models.quant import quantized_bytes
    return quantized_bytes({k: v for k, v in params.items()
                            if k != "embed"})[0]


def report_steady(label: str, steady: dict, nbytes: int) -> None:
    bound_ms = nbytes / smoke.H100_BYTES_PER_S * 1e3
    print(f"{label} steady decode: {steady['step_wall_ms']:.3f} ms wall "
          f"per step, {steady['step_busy_ms']:.3f} ms device busy "
          f"({100 * steady['busy_share']:.1f}%), "
          f"{steady['device_ops_per_step']:.1f} device ops per step; "
          f"weights {nbytes} bytes, bound {bound_ms:.4f} ms", flush=True)
    for kind, ms in steady["ms_by_kind"].items():
        print(f"  {ms:10.4f} ms/step {kind}", flush=True)


def int8_profile(params, cfg, engine_cls, request_cls) -> dict:
    """Steady decode windows on int8 weights: the 154M in both KV
    layouts, and once more contiguous with K7 displaced by the einsum
    route (``_use_kernel`` patched to False for that window only: the
    route the JAX package takes by default); then the 660M with bf16
    and with int8 weights."""
    from k8s_dra_driver_tpu_torch.models import quant as qm
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    out = {}
    qparams = qm.quantize_params(params, cfg)
    for key, label, kw, kernel in (
            ("contiguous", "contiguous", {}, True),
            ("paged", "paged", {"kv_layout": "paged"}, True),
            ("contiguous_einsum", "contiguous, einsum route", {}, False)):
        def make_engine(kw=kw):
            return engine_cls(qparams, cfg, slots=8, top_k=50, **kw)
        with mock.patch.object(qm, "_use_kernel",
                               qm._use_kernel if kernel
                               else lambda m: False):
            steady = steady_profile(make_engine, request_cls, cfg.vocab)
        nbytes = weight_bytes(qparams)
        report_steady(f"154M int8 weights, {label}", steady, nbytes)
        out[f"154m_int8_{key}"] = {**steady, "weight_bytes": nbytes}
    del qparams
    big = config_660m()
    p660 = init_params(big, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    for label in ("bf16", "int8"):
        p = p660 if label == "bf16" else qm.quantize_params(p660, big)

        def make_engine(p=p):
            return engine_cls(p, big, slots=8, top_k=50)
        steady = steady_profile(make_engine, request_cls, big.vocab)
        nbytes = weight_bytes(p)
        report_steady(f"660M {label} weights, contiguous", steady, nbytes)
        out[f"660m_{label}"] = {**steady, "weight_bytes": nbytes}
        del p
    return out


def main() -> None:
    kind = smoke.phase_device()
    from k8s_dra_driver_tpu_torch.models.serving import (Request,
                                                         ServingEngine)
    from k8s_dra_driver_tpu_torch.ops import _build
    _build.library()
    cfg, params = smoke.serving_model()
    reqs = smoke.s8_r24(cfg.vocab)
    out = {}
    for label, kw in (("contiguous", {}), ("paged", {"kv_layout": "paged"})):
        def make_engine(kw=kw):
            return ServingEngine(params, cfg, slots=8, top_k=50, **kw)
        drain = drain_profile(make_engine, reqs)
        steady = steady_profile(make_engine, Request, cfg.vocab)
        report(label, drain, steady)
        out[label] = {"drain": drain, "steady": steady}
    train = train_profile()
    report_train(train)
    moe = train_profile(smoke.moe_heavy_config(
        aux_loss_weight=smoke.MOE_AUX_WEIGHT), smoke.MOE_B, smoke.MOE_T)
    report_train(moe, "moe_heavy train step (gmm)")
    gang = {}
    for dp in (4, 2):
        gang[dp] = train_profile(dp=dp)
        report_train(gang[dp], f"154M gang step, dp={dp} rows")
    int8 = int8_profile(params, cfg, ServingEngine, Request)
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    fused = {}
    for label, p, eager in (
            ("bf16", params, out["contiguous"]["steady"]),
            ("int8", quantize_params(params, cfg),
             int8["154m_int8_contiguous"])):
        def make_engine(p=p):
            return ServingEngine(p, cfg, slots=8, top_k=50,
                                 chain_steps=smoke.FUSED_CHAIN)
        fused[label] = fused_steady_profile(make_engine, Request, cfg.vocab)
        report_fused(f"154M {label} weights, contiguous", fused[label], eager)
    spec = {}
    for label, kw in (("n-gram", {"draft_source": "ngram"}),
                      ("self-draft", {"draft_params": params,
                                      "draft_cfg": cfg})):
        def make_engine(kw=kw):
            return ServingEngine(params, cfg, slots=8, top_k=50,
                                 chain_steps=smoke.FUSED_CHAIN,
                                 draft_len=smoke.SPEC_DRAFT_LEN, **kw)
        spec[label] = spec_steady_profile(make_engine, Request, cfg.vocab)
        report_spec(f"154M bf16 weights, {label}", spec[label],
                    fused["bf16"])
    lora = {}
    names = [f"l{i}" for i in range(8)]
    for label, chain, plain in (
            ("eager", 1, out["contiguous"]["steady"]),
            ("fused", smoke.FUSED_CHAIN, fused["bf16"])):
        def make_engine(chain=chain):
            return ServingEngine(params, cfg, slots=8, top_k=50,
                                 chain_steps=chain,
                                 adapter_pool=smoke.lora_pool(cfg, names, 8))
        profile = steady_profile if chain == 1 else fused_steady_profile
        lora[label] = profile(make_engine, Request, cfg.vocab, names)
        report_lora(f"154M bf16 weights, contiguous, {label}", lora[label],
                    plain)
    print(json.dumps({"device": kind, "layouts": out, "train": train,
                      "moe_train": moe, "gang_train": gang,
                      "int8": int8, "fused": fused,
                      "spec": spec, "lora": lora}), flush=True)


if __name__ == "__main__":
    main()
