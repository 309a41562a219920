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
   decode steps, then profiles another window of the same length.

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
and the routing (sorts, counts, index scatters and gathers).

The last line is one JSON object with those numbers.  Exits non-zero
without a card.  Imports nothing of JAX and nothing of the JAX
package.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke

WINDOW = 32      # decode steps per steady-state window
TRAIN_WINDOW = 3  # training steps timed, then as many profiled
TOP = 10         # device ops listed per run

# device ops by kind, matched on the kernel's name in this order
KINDS = (
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K3 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K4 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("K6 gmm_dw", ("gmm_dw_kernel",)),
    ("K5 gmm", ("gmm_kernel",)),
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


def steady_profile(make_engine, request_cls, vocab: int) -> dict:
    """Eight slots decoding, no fills: per-step wall time over WINDOW
    steps, then per-step device time and ops over WINDOW more."""
    eng = make_engine()
    rng = np.random.default_rng(1)
    for i in range(8):
        prompt = rng.integers(0, vocab, 96).astype(np.int32)
        eng.submit(request_cls(uid=f"s{i}", prompt=prompt,
                               max_new=2 * WINDOW + 16))
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
            "top": summary["top"]}


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
                  t: int = smoke.TRAIN_T) -> dict:
    """Wall and device time per full-width training step of ``cfg``
    (default the 154M configuration) at B=b x T=t."""
    from k8s_dra_driver_tpu_torch.models.transformer import make_train_step
    cfg = cfg or smoke.serving_config()
    step, init_state = make_train_step(cfg, device="cuda")
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
    for what, rows in (("drain", drain["top"]),
                       ("steady window", steady["top"])):
        print(f"{label} {what}, top device ops:", flush=True)
        for row in rows:
            print(f"  {row['ms']:10.3f} ms {row['count']:7d}x "
                  f"{row['op']}", flush=True)


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
    print(json.dumps({"device": kind, "layouts": out, "train": train,
                      "moe_train": moe}), flush=True)


if __name__ == "__main__":
    main()
