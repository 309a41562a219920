"""How far bf16 K3/K4 sit from plain versions whose first products are
summed in other orders, on the card.

Run from the root of a checkout on a machine with one NVIDIA Hopper
card:

    python3 chip_bwd_rounding.py

``flash_block_grads_reference`` rounds p and ds to bf16 before the
second products, where the TPU kernels and the tensor-core K3/K4 round
them.  A bf16 step is 2^-8 of the value, so which side of a rounding
boundary p or ds falls on depends on the last bits of the f32 scores
and dp it is formed from, that is on the order in which their first
products (S = Q K^T, dP = dO V^T) were summed.  For the six bf16 cases
of ``chip_smoke.py``'s phase 5 (its generator seed and shapes) this
prints, for dq, dk and dv, the largest gap relative to max(1,
max|ref|) between

- the kernels and the plain version as committed (on the card its
  bf16 first products are summed on the tensor cores, as the kernels
  sum them);
- the kernels and the same plain version with f32-einsum first
  products (cuBLAS's f32 product);
- the kernels and the same with float64 first products rounded to f32
  (the exact sums, correctly rounded);
- the f32-einsum and the float64 plain versions;

then the kernels' CUDA-event times at the training shape, and a JSON
line with all of it.  Measurement only: no gate.  Imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
from unittest import mock

import torch

import chip_smoke as smoke


def first_f32(x, y):
    return torch.einsum("bqhd,bkhd->bhqk", x.float(), y.float())


def first_f64(x, y):
    return torch.einsum("bqhd,bkhd->bhqk", x.double(), y.double()).float()


def gap(got, want) -> list[float]:
    return [((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
            for g, w in zip(got, want)]


def main() -> None:
    kind = smoke.phase_device()
    from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(4)
    full = dict(b=8, t=2048, tk=2048, h=16, h_kv=4, d=64, window=None,
                seg=False, q_off=0, k_off=0, k_end=None)
    cases = [full, dict(full, window=256), dict(full, seg=True),
             dict(full, b=2, d=128),
             dict(full, b=2, t=1024, tk=1024, q_off=1024, k_off=0),
             dict(full, b=2, t=512, tk=1024, q_off=1536, k_off=512,
                  k_end=1400, window=700)]
    rows = []
    for c in cases:
        b, t, tk, h, h_kv, d = (c["b"], c["t"], c["tk"], c["h"],
                                c["h_kv"], c["d"])

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)

        q, do = rnd(b, t, h, d), rnd(b, t, h, d)
        k, v = rnd(b, tk, h_kv, d), rnd(b, tk, h_kv, d)
        seg = None
        if c["seg"]:
            cuts = torch.randint(0, 512, (b, t), generator=gen,
                                 device="cuda")
            seg = torch.cumsum((cuts == 0).to(torch.int32), dim=1).to(
                torch.int32).contiguous()
        out, lse, _ = smoke.block_forward(fa, q, k, v, c["q_off"],
                                          c["k_off"], c["window"],
                                          c["k_end"], seg, seg)
        delta = fa.attention_delta(do, out)
        del out
        args = (q, k, v, do, delta, lse, c["q_off"], c["k_off"])
        kw = dict(window=c["window"], k_valid_end=c["k_end"],
                  q_segments=seg, k_segments=seg)
        got = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
        refs = {"tensor cores": fa.flash_block_grads_reference(
            *args, True, d ** -0.5, **kw)}
        for name, first in (("f32", first_f32), ("f64", first_f64)):
            with mock.patch.object(fa, "_first_product", first):
                refs[name] = fa.flash_block_grads_reference(
                    *args, True, d ** -0.5, **kw)
        row = dict(case={n: c[n] for n in ("b", "t", "tk", "d", "window",
                                            "seg", "q_off", "k_off",
                                            "k_end")},
                   kernels_vs={n: gap(got, r) for n, r in refs.items()},
                   f32_vs_f64=gap(refs["f32"], refs["f64"]))
        rows.append(row)
        print(f"{row['case']}: (dq, dk, dv) kernels vs plain with first "
              f"products on the tensor cores {row['kernels_vs']['tensor cores']}"
              f", in f32 {row['kernels_vs']['f32']}, in f64 "
              f"{row['kernels_vs']['f64']}; f32 vs f64 plain "
              f"{row['f32_vs_f64']}", flush=True)
        del refs, got
        if c is full:
            times = {"K3_ms": smoke.cuda_ms(lambda: fa.flash_bwd_dq(*args)),
                     "K4_ms": smoke.cuda_ms(lambda: fa.flash_bwd_dkv(*args))}
            print(f"B=8 T=2048 causal bf16, CUDA events: {times}",
                  flush=True)
    print(json.dumps({"device": kind, "cases": rows, "times": times}),
          flush=True)


if __name__ == "__main__":
    main()
