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
   the serving path's shapes and the training shape, with timings and
   the card's bound: bf16 on the tensor-core route, its output before
   the final rounding held to ``flash_forward_reference`` (which rounds
   q and p where the TPU kernel does, per key tile of the kernel) and
   more loosely to the f32 oracle ``attention_forward``; f32 on the
   CUDA-core route;
3b. K1's block entry (``flash_block_attention``: q against one K/V
   block at absolute offsets, Tq != Tk, q/k segments, the unnormalized
   statistics o, m, l) on both routes, D = 64 and 128, against
   ``flash_block_attention_reference`` at a ring's offset pairs (full
   block, diagonal, a block wholly above the diagonal whose rows must
   come out m = -1e30, l = 0, o = 0 exactly, a window crossing the
   block, 192 x 320, distinct q/k segments); S = 4 hops merged with
   ``merge_flash_stats`` against the normalized K1; times at the ring's
   hop shape (B=8 Tq=Tk=1024 H=16 Hkv=4 D=64 bf16, diagonal and full)
   beside the bound, the plain version and SDPA (a yardstick);
4. K2 (paged decode) likewise, with each case's plan (splits, blocks)
   printed, a bitwise repeat of every case, rows over several splits
   (the merge) required and the merge's counters back at 0;
5. K3 (flash backward dq) and K4 (dk/dv) against their plain version
   at the training shape (B=8 T=2048 H=16 Hkv=4 D=64 bf16 causal), with
   a window, segments, D=128, f32 and two ring-style blocks (offsets,
   Tq != Tk, a valid-key end): bf16 on the tensor-core route against
   ``flash_block_grads_reference`` and, more loosely, against the f32
   oracle ``attention_block_grads``; f32 on the CUDA-core route against
   the oracle;
6. K5 (grouped matmul, plain and transposed read) and K6 (its dw)
   against ``gmm_reference`` / ``gmm_dw_reference`` at the moe_heavy
   shapes (18,432 static rows, 16 experts, d 512, f 4096, both expert
   matrices), in bf16 (K5 and K6 on the tensor-core route; bf16 K6's
   bf16 output, the backward's form, must equal its f32 output
   rounded) and f32 (the CUDA-core route), over four group layouts
   (the router's own, one hot expert, empty experts, a long dead
   tail), with timings (K6 also at the hot expert), the bound from the
   live rows and ``torch._grouped_mm`` as the library yardstick, held
   to the plain version too;
7. the serving engine, contiguous KV, at the full width of the 154M
   configuration (vocab 32000, d_model 1024, 8 layers, 16 heads, 4 KV
   heads, d_ff 4096, max_seq 2048, bf16, random weights from a fixed
   generator) draining the s8_r24 traffic (8 slots, 24 requests,
   prompt lengths 96/48/72/24, max_new 48, four of them sampled);
   every greedy stream is held to a teacher-forced pass of
   ``forward``;
8. the same with the paged KV layout and the paged kernel, then once
   more on a pool small enough to force preemption;
9. training, small: one f32 AdamW step of a 2-layer config on the card
   (kernels; K1/K3/K4 on their f32 route) and on the CPU (plain
   versions), loss and parameters compared;
10. training, full width: the 154M configuration, 6 AdamW steps of
    B=8 x T=2048 over a repeated-motif token file read by
    ``BatchLoader``; losses finite and falling, every K1, K3 and K4
    launch on the tensor-core route (8 each per step); a checkpoint at
    step 3 restored into a fresh state must equal the saved state
    bitwise and resume to losses within
    RESUME_TOL of the uninterrupted run; one step under remat launches
    K1 twice per layer;
10b. training recovery (``phase_gang_recovery``): the 154M supervised
    by ``GangSupervisor`` over ``ElasticTrainJob(chips=4)``, every dp
    row of a step its own forward and backward: (a) the kill arc of
    the JAX package's supervisor test in bf16 (dp 4 -> 2, restored
    step 4, the transitions, steps once, the contract, the metrics,
    K1/K3/K4 exactly n_layers x the rows of each step; MTTR, each
    sharded generation's bytes, save ms and MiB/s, the restore ms and
    the steady step walls at dp=4 and dp=2 printed), (b) a wedged
    worker caught by the step deadline, (c) the kill arc in f32 within
    1e-4 of an uninterrupted run, then a flipped byte: the restore
    falls back a generation and ``read_slice`` raises, (d) a resize, a
    park and an unpark at a checkpoint step: no step lost, no device
    memory held while parked, (e) the recovery, fleet and multi-tenant
    probes on the card, each ``valid``;
10c. the compound-fault crucible (``phase_crucible``): the port's
    ``CrucibleRig`` (a ShardedGateway over a one-prefill, one-decode
    paged, tiered, LoRA pool, two elastic gangs on
    ``ShardedCheckpointer``, the multi-tenant reconciler over an
    8-slot ledger, the burn engine) under the seeded default schedule
    of every fault kind: (a) 220 cycles at the reference crucible's
    proportions with d_head 64 (the kernels' head dims) in f32, every
    assertion of the reference acceptance (no violation, every kind
    fired, >= 3 overlaps, the four window-triggered arcs inside their
    windows, every request finished byte-equal to its oracle, both
    gangs recovered with losses exactly once, no burn alert) and K1,
    K2, K3, K4 launched; (b) the same gates at full width (engines and
    oracles on the 154M in f32, gangs on the 154M's widths at 2 layers in
    bf16, 88 cycles),
    with the generations saved (count, bytes, mean ms) and the
    restores; (c) the spec-fleet schedule run twice, equal injection
    logs, fired cycles, outcomes and tokens, and its repro replayed to
    the same fired cycles;
11. MoE training, small: one f32 AdamW step of a 2-layer, 4-expert
    gmm config with the router aux losses, card against CPU, every
    parameter (router included) moved, exact K1/K3-K6 launches (K1,
    K3/K4, K5 and K6 on the f32 route);
12. MoE training, full width: moe_heavy (vocab 1024, d_model 512, 4
    layers, 4 heads, d_ff 4096, 16 experts, top_k 2, bf16) with gmm
    dispatch, 6 AdamW steps of B=8 x T=1024 from a token file,
    load-balance weight 0.01; losses finite and falling, exactly 16
    K5, 8 K6 and 4 each of K1, K3, K4 per step, K1, K3-K6 on the
    tensor-core route; three steps repeated
    from the same seed bitwise; one forward under gmm against dense
    dispatch;
13. MoE serving: a contiguous drain of s8_r24 at moe_heavy (served
    with dense dispatch), every greedy stream held to a teacher-forced
    forward under gmm dispatch (K5);
14. K7 (weight-only int8 matmul; K7a ``int8_matmul``, K7b ``int8_bmm``)
    against ``int8_matmul_reference`` / ``int8_bmm_reference`` at the
    154M decode shapes (M = 1, 8, 64), the 660M shapes, off-gate M =
    96 and 768, a ragged shape, and moe_heavy's expert products (shared
    x, transposed view), in bf16 (the tensor-core route) and f32 (the
    CUDA-core route), each case's plan (K split across blocks) printed,
    with the device memory cache (L2) flushed before every timed call,
    the bf16 cuBLAS product and ``torch._weight_int8pack_mm`` as
    yardsticks, and the bound;
15. int8 serving at 154M: ``quantize_params`` of the same bf16 weights,
    held to the full-precision logits on one 8 x 96 forward; three
    drains of s8_r24 (contiguous KV, contiguous int8 KV, paged KV), each
    passing the teacher-forced check against a full ``forward`` on the
    same int8 weights (M > 64 there: the einsum route) and launching K7a
    49 times (6 per layer + the unembedding) for each forward pass it
    serves: a whole number of passes, at least the drain's decode steps
    and at most all its forward passes (by dispatch label), every one
    on the tensor-core route;
16. fused generation blocks (``phase_fused_serving``): s8_r24 drained
    on the step engine and at ``chain_steps`` = 47 (the JAX package's
    serving probe), where every block is one replay of a captured CUDA
    graph, for the 154M on bf16 weights, on int8 weights (K7a inside
    the graph) with the contiguous cache and with the int8 KV cache,
    and for moe_heavy in f32: f32 streams byte-equal to the step
    engine's, bf16 ones within the teacher-forced margin (the
    byte-equal count printed), K7a exactly 49 a pass with the graphs'
    passes counted as decode passes, no block outside a graph,
    dispatches plus readbacks per token at least 8x fewer; tokens/s,
    wall ms per decode step and per token beside the step engine's,
    graphs captured and their seconds;
17. speculative decoding (``phase_spec_serving``, ``draft_len`` 4):
    s8_r24 on the 154M with the n-gram source (contiguous step by step
    and at ``chain_steps`` = 47, paged on the full pool and on 41
    blocks, which preempts) and with the target as its own draft (step
    by step and fused, on bf16 and on int8 weights, K7a in the graph
    for target and draft; f32 step by step): every fused block one
    graph replay and its streams byte-equal to the step drain's, K7a
    exactly 49 a target and a draft pass, no K2 and spec trims on the
    paged drains, the f32 self-draft accept rate at least 0.8; each
    drain's tokens/s, wall ms a window, windows, accept rate and
    dispatches plus readbacks a token beside the non-speculative drain
    of the same call; then ``spec_accept_rows`` alone on 16384 rows
    against the closed-form target distribution (total variation), and
    the ported spec-decode probe in bf16 and f32, byte-equal to its
    closed-form ramp;
18. multi-adapter LoRA serving (``phase_lora_serving``): s8_r24 on the
    154M with six rank-16 adapters from ``make_adapter`` over a pool of
    four resident slots (base rows and adapter rows in every batch, so
    the drains evict and cold-load), drained contiguous step by step
    and fused, paged (K2), on int8 weights step by step and fused (K7a
    in the graph), with the n-gram source step by step and fused, and in
    f32: every pool buffer at its address after each drain; base rows
    byte-equal to the adapter-less drain of the call; adapter rows
    apart from it; fused byte-equal to step, 24/24; K2 exactly n_layers
    a paged step call, K7a exactly 49 a pass; no capture in a fused
    drain's measured run while it cold-loads; every greedy stream
    within TF_MARGIN teacher-forced (adapter rows through the base
    prefill and an adapter window); in f32 every stream byte-equal to
    one-adapter oracle engines of the same slot count (in bf16
    counted); then the pool's probe at the 154M in bf16 and f32 (switch
    and cold-load times, the churn's hit share);
18b. disaggregated prefill/decode and the KV tiers
    (``phase_disagg_tiers``): s8_r24 exported by a prefill engine
    (``prefill_export``) and adopted in request order by a decode
    engine (``adopt_block``) for the four layout pairs in bf16 (no K1
    on a decode side, K2 exactly n_layers a paged decode step, greedy
    streams within TF_MARGIN, the count equal to phase 8's unified
    paged drain printed) and paged into paged in f32 (every stream
    byte-equal to a unified f32 paged drain); the tier acceptance arc:
    a 1024-token prefix warmed on a tiered (256 MiB host arena), an
    all-HBM and a recompute paged engine, flushed, then ridden back by
    a wave of 8 requests (32-token suffixes, max_new 32, two sampled):
    tiered streams byte-equal to the all-HBM engine's with no
    ``prefill`` launch and one ``paged_slab_adopt``, the recompute
    twin's within TF_MARGIN; the prefix spilled to a temporary
    directory and promoted by a fresh engine (residency (1024, "disk"),
    streams byte-equal to the all-HBM engine's); the promotion's pieces
    (gather, crc32, adopt, suffix fill) against a full prefill; the
    ported tier probe at the 154M in bf16 and f32 (promote and
    recompute ms; byte-equal gated in f32, the churn's hit share above
    0);
18c. the fleet (``phase_fleet``): s8_r24 in three bursts of 8 through
    two-replica pools of 8-slot engines, r0 downed through the health
    signal after its first wave: f32 paged (every uid finished exactly
    once, 1 drain, the requeued count, the replacement up, every stream
    byte-equal to one f32 paged engine's, K2 exactly n_layers a paged
    decode step and K1 n_layers a fresh prefill, the gateway's metric
    samples) and bf16 contiguous (exactly once, greedy streams within
    TF_MARGIN teacher-forced, the byte-equal count printed); a
    one-prefill, two-decode f32 paged pool behind ``DisaggRouter``
    (exactly once, byte-equal, 24 migrations in the migrator and the
    metrics, no ``prefill*`` label on a decode replica and no
    ``decode_*`` on the prefill replica, every request finished on a
    decode replica) and its prefill replica downed after the first
    export wave (exactly once, decode-side prefills, byte-equal); the
    gateway and disagg probes at the 154M in bf16 (accounting gated)
    and the disagg probe in f32 (byte-equality gated); same-card
    migration costs of a bf16 [1, 2048] cache and a 96-token slab;
18d. the multi-process gateway (``phase_procfleet``): three pump
    processes, each with its own CUDA context and one 8-slot f32
    contiguous replica of the 154M (``procpump.tiny_model``), behind
    ``ProcessGateway``; s8_r24 in three bursts, the pump holding r0
    SIGKILLed at the cycle after the first burst's dispatch: every uid
    finished exactly once, the outcome journal's replay clean, one pump
    death and requeued outcomes, every stream byte-equal to one f32
    contiguous engine in this process on the same ``tiny_model``
    weights, each survivor's K1 (read over the wire) a positive multiple
    of n_layers on the f32 route; four s8_r24 KV blocks (one sampled)
    exported by one surviving pump and adopted by the other over the
    wire, equal to the oracle (frame bytes and export, encode, pipe,
    decode, adopt, generation ms printed); a bf16 [1, 1024] block of
    the 154M through the wire codec and JSON in this process, every leaf
    bit-equal and its stream equal (encode, JSON and decode ms beside a
    same-card copy); the multi-process scaling probe with null engines
    at 1, 2 and 4 pumps (printed, not gated);
18e. serving observability (``phase_observability``, params made in
    the phase): a 154M bf16 paged engine's ``MemWatch`` ledger against
    the card allocator's rise over its build (``model_params`` +
    ``paged_kv_pool`` equal to the tensors' ``numel x element_size``
    exactly, the rise within LEDGER_TOL of the ledger, source
    ``"device"``), s8_r24 drained through it (teacher-forced, exact K1
    and K2 launches, the ledger unchanged, the allocator's residue
    printed); ``observatory_probe`` at bench.py's tiny request counts
    with the 154M as its engine (``valid``, source ``"device"``, the
    merged digest count = the per-pump sum; ``digest_overhead_x``
    printed); ``paged_kv_probe`` at the 154M in f32 (``byte_equal``, CoW
    share > 0, no allocation failure, concurrency above contiguous,
    exact K1 and K2 launches) and in bf16 (printed);
18f. the fleet control loop (``phase_fleet_control``): (a)
    ``FleetReconciler`` over f32 paged 154M replicas on allocation
    labels 0-3 of this card, with the burn-rate engine, ``MemWatch`` and
    a tracer: a burst under a tight deadline, calm, a label marked
    unhealthy and healed (exactly once, 24/24 byte-equal to one f32
    paged engine, scale-up, drain-then-retire, the ledger's owners = the
    live replicas' labels every tick, one reap and one heal, MemWatch's
    units = the live replicas every step, a burn-rate alert and none in
    a calm control run, exact K1 and K2 launches; the critical path's
    parts = its wall, ``export_chrome`` deterministic, ``/metrics`` with
    the fleet, gateway and MemWatch families); (b)
    ``MultiTenantReconciler`` over two bf16 tenants (adapter evictions
    before any chip action, reclaims only from the low tenant and never
    below its floor, a grant and a calm release, exactly once in both,
    exact K1 and K2 launches; ``fairshare_error`` printed);
19. int8 MoE serving: the moe_heavy drain in f32 on ``quantize_params``
    weights, dense dispatch, the teacher-forced check, K7b twice per
    layer and K7a 4 per layer + 1 for each such pass, over the same
    passes, every one on the CUDA-core route;
20. tensor, expert and pipeline parallelism (``phase_mesh_train``):
    worker processes sharing the card over gloo; f32 2-layer steps over
    tp=2 and ep=2 x tp=2 (MoE gmm, four ranks) against one CPU process,
    loss, gathered gradients and parameters; the 154M over tp=2 (8 of
    16 heads a rank) and over pp=2 (GPipe, 4 layers a stage, 4
    microbatches) and moe_heavy over ep=2 (8 experts and a dead group a
    rank), SP_STEPS steps each against the single-device losses, exact
    per-rank K1/K3/K4/K5/K6 launches on the tensor cores;
20b. the measurement utilities (``phase_measure``): (a) the
    autotuner names the card (``backend_key``), the checked-in H100
    table is empty so every K7 launch of the run took ``int8_plan``'s
    plan (picks by source printed, none measured), ``Autotuner.tune``
    times K7a at the 154M unembedding and K7b at moe_heavy's
    up-projection over a few ``k_chunk``/``ring`` plans with the
    differential-median harness (each plan valid only within INT8_TOL
    of its plain version), and the saved table, pointed to by
    ``TPU_AUTOTUNE_TABLE``, makes the wrappers launch the tuned plans
    within tolerance before the default is restored; (b) every probe of
    ``ops/collectives.py`` (attention forward and gradient, the matmul
    yardstick, decode on bf16 and int8 weights, serving at chain_steps
    1 and 47, dispatch, the one-card all-reduce) at its defaults,
    ``valid`` under the H100 ceilings, its K1, K3/K4 and K7 launches
    joining the kernels line; (c) a Chrome trace of one 154M generation
    step holding the ``annotate`` span and K1, a device memory
    snapshot, and the fleet simulator's probe (1000 replicas, seed 7,
    20 cycles, a 70-cycle A/B), which runs on the host in a process of
    its own from the end of the kernel checks (phases 3-6, 14) on: no
    violation, every cycle survived, the minimized repro starving, and
    a same-seed rerun of its soak with an equal journal digest;
21. each kernel's device time at its main-path shape and at a long
    context (torch.profiler), after the drains and the steps so that
    profiling cannot tax them;
22. one JSON line naming every kernel with its launches on the main
    paths (serving drains and training steps), its error against the
    plain version and its times; K1, K3-K6 name their tensor-core
    source and launches, and their f32 route's apart; K7 its launches
    by route.  A kernel or library reading below its bound is flagged
    impossible, re-timed cold and, if still below, not used;
23. last line: ``{"ok": true, "device": {...}}``.

Every drain and step holds its K1, K5, K6 and K7 launches to the route
of its dtype: bf16 on the tensor cores, f32 on the CUDA cores.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import atexit
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# bf16 outputs are rounded to 8 mantissa bits (relative 2^-8, about
# 0.004 at |x| <= 1) and the kernel sums in another order than the
# plain version; f32 differs only by summation order and expf.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-3
# bf16 K1 (tensor cores) against its rounding plain version
# flash_forward_reference, relative to max(1, max|plain|), on the output
# before its final rounding: the kernel forms q' and p with the plain
# version's operations, and the plain version sums its bf16 scores on
# the tensor cores in the kernel's order, so only the sums of l and of
# p.v part them (a few units in the last place); a bf16 step of one p
# would show as about 4e-3 of that p's row, and the version without the
# TPU kernel's roundings misses JAX's kernel by 6.9e-4 to 1.7e-3 of
# max(1, max|ref|) (tests/test_torch_flash_fwd.py's cases on the CPU).
# Held as well: the bf16 output is that f32 output rounded, bit for
# bit, and it stays within TOL[bf16] of the f32 oracle
# attention_forward.
FWD_TC_TOL = 1e-4
# teacher-forced check: each greedy token's logit in one full-sequence
# forward pass must be within this of that position's max.  bf16 decode
# (stepwise cache reads) and the full forward round differently; with
# random weights the top two logits are often ~0.2 apart.
TF_MARGIN = 0.1

# K3/K4 against their plain version, relative to the largest gradient
# entry (about 10 at the training shape): in f32 attention_block_grads,
# in bf16 flash_block_grads_reference, which rounds p and ds to bf16
# where the kernels (and the TPU kernels) do.  Both sum exact products
# of the same operands in f32 and differ in summation order over up to
# 2048 terms and in exp's last bits, which may round an entry of p or
# ds to the neighbouring bf16 value.
BWD_TOL = 1e-3
# bf16 K3/K4 against the f32 oracle attention_block_grads, which keeps
# p and ds in f32: JAX's own Pallas kernels, which round them, are about
# 2e-3 of max|ref| from it on the CPU (B=1 T=128 H=4 Hkv=2 D=64 causal
# bf16; 0.8-2.2e-3 in tests/test_torch_flash_bwd.py)
BWD_BF16_ORACLE_TOL = 1e-2
# training, f32 card (kernels) vs CPU (plain): summation order only; a
# missing or wrong gradient moves a weight by a whole AdamW step (lr
# 3e-4), three times this bound
STEP_LOSS_RTOL = 1e-4
STEP_PARAM_ATOL = 1e-4
# resumed vs uninterrupted losses: the embedding gather's backward sums
# rows in an order that may change between runs (bf16 weights, one
# rounding step is 2^-8 relative), so three bf16 steps may part by a
# few thousandths at a loss near 10
RESUME_TOL = 2e-2
TRAIN_STEPS = 6
TRAIN_SAVE_AT = 3
TRAIN_B, TRAIN_T = 8, 2048

# K5 against gmm_reference, relative to max(1, max|plain|): both sum in
# f32 and differ in order only; in bf16 the two f32 sums may round to
# neighbouring bf16 values (2^-8 of the value, below 4e-3 of the max).
GMM_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# K6 against gmm_dw_reference: f32 output from inputs that f32 holds
# exactly (bf16 products are exact in f32), so summation order over up
# to 16,384 rows is the only difference
DW_TOL = 1e-4
# moe_heavy training (gmm dispatch) at the JAX package's MoE batch
MOE_B, MOE_T = 8, 1024
MOE_AUX_WEIGHT = 0.01
# gmm against dense dispatch on one forward of the same weights in f32:
# the same expert products summed in another order (K5 against cuBLAS),
# held relative to max(1, max|dense|).  Not in bf16: there the router's
# bf16 logits tie at the k-th gate for about 1% of tokens, and the two
# dispatches of the JAX package itself part there (dense keeps every
# expert tied with the k-th gate, gmm's top-k exactly k), by whole
# logits; the bf16 gap and its tie count are printed, not held.
DISPATCH_TOL = 1e-3
# f32 steps card vs CPU: parameters whose gradient is nonzero but
# below this fraction of its tensor's largest entry are rounding noise
# for AdamW's first update (see step_param_errors)
NOISE_BAND = 1e-5

# K7 against its plain version, relative to max(1, max|plain|): both sum
# exact products of the same inputs in f32, in another order; a bf16
# output may round to the neighbouring bf16 value (2^-8 of the value)
INT8_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# quantize_params against the full-precision weights on one forward, as
# the JAX package's test holds them (tests/test_quant.py)
QUANT_MEAN_REL = 0.05
QUANT_AGREE = 0.9

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


_flush: list = []


def flush_l2() -> None:
    """Overwrite a 64 MiB buffer, more than the card's 50 MB L2, so the
    next call reads its inputs from device memory."""
    if not _flush:
        _flush.append(torch.empty(64 << 20, dtype=torch.uint8,
                                  device="cuda"))
    _flush[0].zero_()


def cold_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of ``fn()`` between CUDA events around each call, with
    the L2 flushed before it: the case of a decode step, which streams
    more weights than L2 holds.  The card spins for about 0.5 ms after
    the flush, so the host has enqueued the call before the first event
    fires and the events time the device, not the host's launch."""
    start = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for _ in range(warmup):
        fn()
    for i in range(iters):
        flush_l2()
        torch.cuda._sleep(1_000_000)
        start[i].record()
        fn()
        end[i].record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(start, end)) / iters


def cold_device_ms(fn, iters: int = 10) -> float | None:
    """Device time of ``fn()`` after an L2 flush: the profiled time of
    flush + call less that of the flush alone."""
    both = device_ms(lambda: (flush_l2(), fn()), iters)
    alone = device_ms(flush_l2, iters)
    return None if both is None or alone is None else both - alone


def trusted(label: str, what: str, ms: float | None, bound_ms: float,
            fn) -> float | None:
    """A reading of ``fn`` no faster than the card allows: ``ms`` when
    it is at least ``bound_ms``.  A faster one is impossible: it is
    flagged and ``fn`` re-timed cold (:func:`cold_device_ms`, L2
    flushed); the re-timing is returned when it is at least the bound,
    else None, so a flagged reading is never used as a yardstick."""
    if ms is None or ms >= bound_ms:
        return ms
    cold = None if fn is None else cold_device_ms(fn)
    ok = cold is not None and cold >= bound_ms
    print(f"{label}: {what} {ms:.4f} ms is below the bound "
          f"{bound_ms:.4f} ms: impossible; cold re-time {fmt(cold)} ms"
          f"{'' if ok else ', still impossible: not used'}", flush=True)
    return cold if ok else None


def fmt(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    return torch.cuda.get_device_name(0)


def ptxas_lines(log: str) -> list[str]:
    """One line per compiled kernel from the ``-Xptxas -v`` log: its
    source, its mangled name, registers, spill bytes and static shared
    memory."""
    out, src, name = [], "", ""
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].split(" ")[0]
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"ptxas {src} {name}: {spills}; "
                       f"{line.split(':', 1)[1].strip()}")
            name = ""
    return out


def phase_build(build) -> None:
    t0 = time.perf_counter()
    build.library()
    took = time.perf_counter() - t0
    print(f"build: {took:.2f} s (nvcc: {build.build_seconds}) log "
          f"{build.build_log}", flush=True)
    print("\n".join(ptxas_lines(build.build_log.read_text())), flush=True)


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
    and the library call at that shape and at B=8 T=2048.

    bf16 runs on the tensor-core route: its f32 output (``out_dtype``
    float32, before the final rounding) is held to
    ``flash_forward_reference`` at FWD_TC_TOL, its bf16 output must be
    that output rounded, bit for bit, and the f32 oracle
    ``attention_forward`` within TOL[bf16].  f32 runs on the CUDA-core
    route, held to the plain version at TOL[f32]."""
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
        dict(b=2, t=2048, d=128, window=None, seg=False,
             dtype=torch.bfloat16),
        dict(b=1, t=300, d=128, window=64, seg=True, dtype=torch.bfloat16),
        dict(b=1, t=96, d=64, window=None, seg=True, dtype=torch.float32),
        dict(b=1, t=2048, d=128, window=32, seg=False,
             dtype=torch.float32),
    ]
    row, probes = None, {}
    for c in cases:
        b, t, d, dtype = c["b"], c["t"], c["d"], c["dtype"]
        tc = dtype == torch.bfloat16
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
        before = fa.tc_launches
        out, lse = fa.flash_forward(q, k, v, **kw)
        if fa.tc_launches != before + tc:
            fail(f"K1 took the wrong route at {c}")
        ref, ref_lse = fa.flash_forward_reference(
            q, k, v, out_dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"K1 non-finite output at {c}")
        scale = max(1.0, ref.abs().max().item())
        lerr = (lse - ref_lse).abs().max().item()
        if tc:
            full, full_lse = fa.flash_forward(q, k, v,
                                              out_dtype=torch.float32, **kw)
            err = (full - ref).abs().max().item()
            rounded = (torch.equal(out, full.to(dtype))
                       and torch.equal(lse, full_lse))
            oracle = fa.attention_forward(q, k, v, **kw)[0]
            oerr = (out.float() - oracle.float()).abs().max().item()
            ok = (err <= FWD_TC_TOL * scale and rounded
                  and oerr <= TOL[dtype] and lerr <= LSE_TOL)
            held = (f"f32 output max|d|={err:.3g} (tol {FWD_TC_TOL} x "
                    f"max(1, max|plain| {scale:.3g})), bf16 output the f32 "
                    f"one rounded: {rounded}; oracle max|d|={oerr:.3g} "
                    f"(tol {TOL[dtype]})")
        else:
            err = (out - ref).abs().max().item()
            ok = err <= TOL[dtype] and lerr <= LSE_TOL
            held = f"max|d|={err:.3g} (tol {TOL[dtype]})"
        ms = cuda_ms(lambda: fa.flash_forward(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: fa.flash_forward_reference(q, k, v,
                                                              **kw),
                           iters=5)
        lib_ms = None
        if seg is None and c["window"] is None:
            lib_ms = cuda_ms(sdpa_fn(q, k, v, True))
        bound, by = flash_bound(b, t, h, h_kv, d, c["window"], seg,
                                dtype)
        print(f"K1 B={b} T={t} H={h} Hkv={h_kv} D={d} "
              f"window={c['window']} seg={seg is not None} "
              f"{str(dtype).removeprefix('torch.')} "
              f"({'tensor cores' if tc else 'CUDA cores'}): {held} lse "
              f"max|d|={lerr:.3g} (tol {LSE_TOL}) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={fmt(lib_ms)} "
              f"bound_us={bound * 1e3:.2f} ({by}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K1 disagrees with its plain version at {c}")
        plain_causal = (seg is None and c["window"] is None and tc)
        if plain_causal and (b, t, d) in ((2, 96, 64), (8, 2048, 64),
                                          (2, 2048, 128)):
            main = " (main path)" if (b, t) == (2, 96) else ""
            probes[f"B={b} T={t} D={d}{main}"] = dict(
                kernel=lambda q=q, k=k, v=v: fa.flash_forward(q, k, v),
                plain=lambda q=q, k=k, v=v: fa.flash_forward_reference(
                    q, k, v),
                library=sdpa_fn(q, k, v, True))
        if plain_causal and (b, t, d) == (2, 96, 64):
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=lib_ms)
    return row, probes


#: K1's block entry against its plain version, relative to max(1,
#: max|plain|) on o and l (m absolute): bf16 as the normalized entry
#: (FWD_TC_TOL: the plain version sums its scores on the tensor cores in
#: the kernel's order), f32 as TOL[f32]; rows the plain version leaves
#: empty must be m = -1e30, l = 0, o = 0 exactly
BLOCK_TOL = {torch.bfloat16: FWD_TC_TOL, torch.float32: TOL[torch.float32]}
#: the ring's hop shape at the 154M over sp=2 (B=8, T/2 = 1024 rows)
HOP_B, HOP_T = 8, 1024


def block_bound(b, tq, tk, h, h_kv, d, pairs, dtype) -> tuple[float, str]:
    """Least time of one block-entry call: q, k, v read once and o, m, l
    (f32) written once over the memory rate; 4*D flops per valid pair
    over the peak rate of the inputs' type."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * (tq * h + 2 * tk * h_kv) * d * es
              + b * tq * h * (d + 2) * 4)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_b, t_f = nbytes / H100_BYTES_PER_S, 4 * d * pairs / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def block_pairs(b, tq, tk, h, q_off, k_off, causal, window, qs, ks) -> int:
    """Valid (query, key) pairs of one block call on these inputs."""
    qpos = q_off + np.arange(tq)[:, None]
    kpos = k_off + np.arange(tk)[None]
    valid = np.ones((tq, tk), bool)
    if causal:
        valid &= kpos <= qpos
        if window:
            valid &= qpos - kpos < window
    if qs is None:
        return b * h * int(valid.sum())
    return h * sum(int((valid & (a[:, None] == c[None])).sum())
                   for a, c in zip(qs.cpu().numpy(), ks.cpu().numpy()))


def check_block(fa, q, k, v, q_off, k_off, label, causal=True, window=None,
                qs=None, ks=None) -> float:
    """One block-entry call against its plain version; fails the run on
    a disagreement or a wrong route.  Returns max|d| of o."""
    tc = q.dtype == torch.bfloat16
    kw = dict(causal=causal, window=window, q_segments=qs, k_segments=ks)
    before = (fa.block_launches, fa.block_tc_launches, fa.launches)
    o, m, l = fa.flash_block_attention(q, k, v, q_off, k_off, **kw)
    after = (fa.block_launches, fa.block_tc_launches, fa.launches)
    if after != (before[0] + 1, before[1] + tc, before[2]):
        fail(f"K1 block {label}: launch counts {before} -> {after}")
    ro, rm, rl = fa.flash_block_attention_reference(q, k, v, q_off, k_off,
                                                    **kw)
    torch.cuda.synchronize()
    dead = rl == 0
    dead_ok = (torch.equal(l == 0, dead) and bool((m[dead] == -1e30).all())
               and bool((o.transpose(1, 2)[dead] == 0).all()))
    scale = max(1.0, ro.abs().max().item())
    err = (o - ro).abs().max().item()
    lerr = (l - rl).abs().max().item() / max(1.0, rl.abs().max().item())
    merr = (m - rm)[~dead].abs().max().item() if (~dead).any() else 0.0
    tol = BLOCK_TOL[q.dtype]
    finite = all(bool(torch.isfinite(x).all()) for x in (o, m, l))
    ok = (finite and dead_ok and err <= tol * scale and lerr <= tol
          and merr <= tol)
    b, tq, h, d = q.shape
    print(f"K1 block {label}: B={b} Tq={tq} Tk={k.shape[1]} H={h} "
          f"Hkv={k.shape[2]} D={d} offsets ({q_off}, {k_off}) "
          f"window={window} seg={qs is not None} "
          f"{str(q.dtype).removeprefix('torch.')} "
          f"({'tensor cores' if tc else 'CUDA cores'}): o max|d|={err:.3g} "
          f"(tol {tol} x max(1, max|plain| {scale:.3g})), l rel "
          f"{lerr:.3g}, m max|d|={merr:.3g}; empty rows "
          f"{int(dead.sum())} exactly (m=-1e30, l=0, o=0): {dead_ok} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"K1 block entry disagrees with its plain version at {label}")
    return err


def phase_flash_block(fa) -> tuple[dict, dict]:
    """K1's block entry (``flash_block_attention``) on both routes,
    D = 64 and 128, GQA 16/4, against ``flash_block_attention_reference``
    at the offset pairs of a ring: the full block, the diagonal, a block
    wholly above it (every row empty), a window crossing the block,
    Tq != Tk (192 x 320), distinct q/k segments.  Then S = 4 hops of one
    sequence merged with ``merge_flash_stats`` and normalized, against
    the normalized K1 (f32 output) within TOL[dtype].  Then times at the
    ring's hop shape (B=8 Tq=Tk=1024 H=16 Hkv=4 D=64 bf16), diagonal and
    full, beside their bounds, the plain version and SDPA (timed only).
    Returns the kernels-line row (the diagonal hop) and the probes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    h, h_kv = 16, 4

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    def segs(b, n):
        cuts = torch.randint(0, 40, (b, n), generator=gen, device=dev)
        return torch.cumsum((cuts == 0).to(torch.int32), dim=1).to(
            torch.int32)

    for dtype in (torch.bfloat16, torch.float32):
        for d in (64, 128):
            t = 256
            q = rand(2, t, h, d, dtype=dtype)
            k, v = rand(2, t, h_kv, d, dtype=dtype), rand(2, t, h_kv, d,
                                                           dtype=dtype)
            for label, qo, ko, window in (("full", t, 0, None),
                                          ("diagonal", 0, 0, None),
                                          ("above the diagonal", 0, t, None),
                                          ("window crossing", t // 2, 0,
                                           100)):
                check_block(fa, q, k, v, qo, ko, label, window=window)
            q2 = rand(2, 192, h, d, dtype=dtype)
            k2, v2 = rand(2, 320, h_kv, d, dtype=dtype), rand(
                2, 320, h_kv, d, dtype=dtype)
            check_block(fa, q2, k2, v2, 300, 100, "Tq != Tk")
            ids = segs(2, 420)
            check_block(fa, q2, k2, v2, 228, 100, "q/k segments",
                        qs=ids[:, 228:].contiguous(),
                        ks=ids[:, 100:420].contiguous())
            check_block(fa, q2, k2, v2, 0, 0, "non-causal segments",
                        causal=False, qs=ids[:, :192].contiguous(),
                        ks=ids[:, 100:420].contiguous())

        # S hops of one sequence, merged, against the normalized K1
        t, s = 1024, 4
        q = rand(2, t, h, 64, dtype=dtype)
        k, v = rand(2, t, h_kv, 64, dtype=dtype), rand(2, t, h_kv, 64,
                                                       dtype=dtype)
        want = fa.flash_forward(q, k, v, out_dtype=torch.float32)[0]
        tl = t // s
        got = []
        for qi in range(s):
            acc = None
            for ki in range(s):
                stats = fa.flash_block_attention(
                    q[:, qi * tl:(qi + 1) * tl].contiguous(),
                    k[:, ki * tl:(ki + 1) * tl].contiguous(),
                    v[:, ki * tl:(ki + 1) * tl].contiguous(), qi * tl,
                    ki * tl)
                acc = stats if acc is None else fa.merge_flash_stats(*acc,
                                                                     *stats)
            got.append(fa.normalize_flash_stats(*acc)[0])
        merr = (torch.cat(got, dim=1) - want).abs().max().item()
        print(f"K1 block: {s} hops of B=2 T={t} merged and normalized vs "
              f"the normalized K1 ({str(dtype).removeprefix('torch.')}, "
              f"f32 output): max|d|={merr:.3g} (tol {TOL[dtype]}) "
              f"{'ok' if merr <= TOL[dtype] else 'FAIL'}", flush=True)
        if merr > TOL[dtype]:
            fail("merged block-entry hops disagree with the normalized K1")

    # the ring's hop shape at the 154M, sp=2
    q = rand(HOP_B, HOP_T, h, 64, dtype=torch.bfloat16)
    k = rand(HOP_B, HOP_T, h_kv, 64, dtype=torch.bfloat16)
    v = rand(HOP_B, HOP_T, h_kv, 64, dtype=torch.bfloat16)
    row, probes = None, {}
    for label, qo, causal in (("diagonal", 0, True), ("full", HOP_T, True)):
        err = check_block(fa, q, k, v, qo, 0, f"hop {label}")
        pairs = block_pairs(HOP_B, HOP_T, HOP_T, h, qo, 0, causal, None,
                            None, None)
        bound, by = block_bound(HOP_B, HOP_T, HOP_T, h, h_kv, 64, pairs,
                                torch.bfloat16)
        kernel = (lambda qo=qo: fa.flash_block_attention(q, k, v, qo, 0))
        plain = (lambda qo=qo: fa.flash_block_attention_reference(
            q, k, v, qo, 0))
        # SDPA of the same pairs: the diagonal is a causal square, the
        # full hop an unmasked one (yardstick only)
        library = sdpa_fn(q, k, v, label == "diagonal")
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, iters=3)
        lib_ms = cuda_ms(library)
        print(f"K1 block hop {label} B={HOP_B} Tq=Tk={HOP_T} H={h} "
              f"Hkv={h_kv} D=64 bf16: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
              f"bound_us={bound * 1e3:.2f} ({by}; {pairs} pairs, "
              f"{4 * 64 * pairs / 1e9:.1f} GFLOP)", flush=True)
        main = " (main path)" if label == "diagonal" else ""
        probes[f"hop {label} B={HOP_B} Tq=Tk={HOP_T}{main}"] = dict(
            kernel=kernel, plain=plain, library=library)
        if label == "diagonal":
            row = dict(max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       library_ms=lib_ms)
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


def paged_cases(pa) -> list:
    """K2's cases: (label, lengths, head dim, dtype).  The first five
    are the bring-up's; then the split kernel's own: one 2048-token row
    (many splits), eight rows of one key, rows ending exactly on and
    next to a span's end (the next span empty or one key long), and
    D=128 at eight 2048-token rows."""
    bf16, f32 = torch.bfloat16, torch.float32
    span = pa.paged_plan(8, 4, 4, 64, 16, 2048 // 16, bf16).pages_per_split * 16
    return [
        ("mixed", [1, 17, 96, 2048, 1, 17, 96, 2048], 64, bf16),
        ("main", [120, 72, 96, 48, 120, 72, 96, 48], 64, bf16),
        ("long", [2048] * 8, 64, bf16),
        ("mixed D=128", [1, 17, 96, 2048, 5, 33, 300, 1000], 128, bf16),
        ("mixed f32", [1, 17, 96, 2048, 5, 33, 300, 1000], 64, f32),
        ("one row", [2048], 64, bf16),
        ("one key", [1] * 8, 64, bf16),
        ("span ends", [span, 2 * span, span - 1, span + 1, 3 * span,
                       2048, 16, span * (2048 // span)], 64, bf16),
        ("long D=128", [2048] * 8, 128, bf16),
    ]


def k2_direct(pa, args, plan) -> torch.Tensor:
    """K2 launched through its C entry on a given plan (outside the
    wrapper and its count): the main path's step on one split, so the
    grid holds no dead blocks, to measure what the dead blocks cost."""
    from k8s_dra_driver_tpu_torch.ops import _build
    q, k_pool, v_pool, tables, lens = args
    b, h, d = q.shape
    _, bs, h_kv, _ = k_pool.shape
    if plan.splits != 1:
        raise ValueError("k2_direct takes one-split plans")
    out = torch.empty_like(q)
    rc = _build.library().paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(), None, None,
        b, h, h_kv, d, bs, tables.shape[1], plan.heads_per_block,
        plan.pages_per_split, 1, d ** -0.5,
        _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "paged_decode")
    return out


def phase_paged(pa) -> tuple[dict, dict]:
    """K2 against its plain version at :func:`paged_cases`, each case's
    plan printed, on pools whose null block is NaN (the kernel must
    never read a tail entry's page); a bitwise repeat of every case;
    the run fails unless
    some row spanned several splits (the merge ran) and every arrival
    counter is back at 0.  Returns the kernels-line row at a mid-drain
    decode step of the s8_r24 paged engine (lengths 120/72/96/48), and,
    by shape, callables of the kernel and its plain version at that
    step, at eight and at one 2048-token rows, of the kernel on a
    one-split grid at the step (no dead blocks), and of one empty
    launch (what a separate merge kernel would add at least)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(2)
    h, h_kv, bs = 16, 4, 16
    n_pages = 2048 // bs
    row, probes, multi = None, {}, 0
    for label, lengths, d, dtype in paged_cases(pa):
        b = len(lengths)
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
        # the kernel reads pools whose null block 0 is NaN, so reading a
        # tail entry's page would show; the plain version gathers every
        # table slot and reads copies whose null block is 0 (its masked
        # keys add exact zeros either way)
        clean = [x.clone() for x in (k_pool, v_pool)]
        for x, c in zip((k_pool, v_pool), clean):
            x[0], c[0] = float("nan"), 0.0
        args = (q, k_pool, v_pool, tables, lens)
        ref_args = (q, *clean, tables, lens)
        plan = pa.paged_plan(b, h_kv, h // h_kv, d, bs, n_pages, dtype)
        span = plan.pages_per_split * bs
        live = [-(-min(n, n_pages * bs) // span) for n in lengths]
        multi += sum(n > 1 for n in live)
        out = pa.paged_attention(*args)
        again = pa.paged_attention(*args)
        ref = pa.paged_attention_reference(*ref_args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        same = torch.equal(out, again)
        ms = cuda_ms(lambda: pa.paged_attention(*args))
        plain_ms = cuda_ms(lambda: pa.paged_attention_reference(*ref_args),
                           iters=5)
        es = torch.tensor([], dtype=dtype).element_size()
        bound, by = paged_bound(lengths, b, h, h_kv, d, es)
        ok = (bool(torch.isfinite(out.float()).all()) and err <= TOL[dtype]
              and same)
        print(f"K2 {label}: B={b} H={h} Hkv={h_kv} D={d} bs={bs} "
              f"lengths={lengths} {str(dtype).removeprefix('torch.')}: "
              f"plan heads_per_block={plan.heads_per_block} "
              f"pages_per_split={plan.pages_per_split} "
              f"splits={plan.splits} blocks={plan.blocks} live splits "
              f"per row={live}: max|d|={err:.3g} (tol {TOL[dtype]}) "
              f"repeat {'bitwise equal' if same else 'DIFFERS'} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms=None bound_us={bound * 1e3:.2f} ({by}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K2 disagrees with its plain version or its repeat at "
                 f"{label} {lengths}")
        if label in ("main", "long", "one row", "long D=128"):
            main = " (main path)" if label == "main" else ""
            probes[f"{label} {lengths[:4]}{main}"] = dict(
                kernel=lambda a=args: pa.paged_attention(*a),
                plain=lambda a=ref_args: pa.paged_attention_reference(*a))
        if label == "main":
            whole = plan._replace(pages_per_split=n_pages, splits=1,
                                  blocks=plan.blocks // plan.splits)
            direct = k2_direct(pa, args, whole)
            torch.cuda.synchronize()
            if not torch.equal(direct, out):
                fail("K2 on a one-split grid differs from the planned "
                     "grid at the main path's step")
            probes[f"{label} on one split, {whole.blocks} blocks"] = dict(
                kernel=lambda a=args, p=whole: k2_direct(pa, a, p))
            # the least a separate merge kernel would add to every call:
            # one launch that does nothing
            probes["one more launch (an empty kernel)"] = dict(
                kernel=lambda: torch.cuda._sleep(0))
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=None,
                       plan=plan._asdict())
    if not multi:
        fail("no K2 case spanned several splits: the merge never ran")
    busy = [int(c.count_nonzero()) for _, c in pa._buffers.values()]
    if not busy or any(busy):
        fail(f"K2's arrival counters are not all back at 0: {busy}")
    print(f"K2: {multi} rows over several splits, merged in split order; "
          f"every arrival counter back at 0", flush=True)
    return row, probes


def block_forward(fa, q, k, v, q_off, k_off, window, k_valid_end, seg_q,
                  seg_k):
    """(out, lse) of one K/V block in plain f32, lse over that block:
    what a forward over the same block hands the backward."""
    mask = fa.block_mask(q.shape[1], k.shape[1], q_off, k_off, True,
                         window, k_valid_end, seg_q, seg_k, q.device)
    group = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(group, dim=2))
    s = (s * q.shape[-1] ** -0.5).masked_fill(~mask[:, None], -1e30)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]),
                       v.float().repeat_interleave(group, dim=2))
    pairs = int(mask.sum()) * (q.shape[0] if mask.shape[0] == 1 else 1)
    return out, lse.contiguous(), pairs * q.shape[2]


def bwd_bound(b, tq, tk, h, h_kv, d, dtype, pairs, seg,
              products: int, n_out: int) -> tuple[float, str]:
    """Least time for one backward kernel: q, do, k, v, lse and delta
    (and segments) read once, its f32 outputs (``n_out`` tensors of q's
    shape for K3, of k's for K4) written once, over the memory rate;
    ``products`` times 2*D flops per valid (q, k, head) pair over the
    peak rate of the inputs' type; the larger of the two."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = ((2 * b * tq * h + 2 * b * tk * h_kv) * d * es
              + 2 * b * h * tq * 4 + (b * (tq + tk) * 4 if seg else 0))
    out_rows = b * tq * h if n_out == 1 else 2 * b * tk * h_kv
    nbytes += out_rows * d * 4
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_b, t_f = nbytes / H100_BYTES_PER_S, products * 2 * d * pairs / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def sdpa_bwd_fn(q, k, v, do, mask=None):
    """The backward of one PyTorch attention call through autograd,
    the forward excluded (yardstick only, never called by the port):
    causal, or under ``mask`` ([B, Tq, Tk] bool, True where a query
    sees a key) passed as one boolean ``attn_mask``."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    group = q.shape[2] // k.shape[2]
    kw = (dict(is_causal=True) if mask is None
          else dict(attn_mask=mask[:, None]))
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        out = F.scaled_dot_product_attention(qt, kt, vt,
                                             enable_gqa=group > 1, **kw)
    else:
        out = F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(group, dim=1),
            vt.repeat_interleave(group, dim=1), **kw)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def phase_flash_bwd(fa) -> tuple[dict, dict, dict]:
    """K3 and K4 against their plain version (bf16: the rounding
    ``flash_block_grads_reference``, and the f32 oracle
    ``attention_block_grads`` at BWD_BF16_ORACLE_TOL; f32: the oracle),
    each case on the route its dtype picks; returns the kernels-line
    rows of both at the training shape and, by shape, callables of each
    kernel, the plain version and the library call there."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    full = dict(b=8, t=2048, tk=2048, h=16, h_kv=4, d=64, dtype=bf,
                window=None, seg=False, q_off=0, k_off=0, k_end=None)
    cases = [
        full,
        dict(full, window=256),
        dict(full, seg=True),
        dict(full, b=2, d=128),
        dict(full, b=2, t=1024, tk=1024, dtype=f32, seg=True),
        # ring hops: a later q block against an earlier K/V block, and
        # a short q block against a longer, tail-padded one
        dict(full, b=2, t=1024, tk=1024, q_off=1024, k_off=0),
        dict(full, b=2, t=512, tk=1024, q_off=1536, k_off=512,
             k_end=1400, window=700),
    ]
    rows, probes = {}, {"K3": {}, "K4": {}}
    for c in cases:
        b, t, tk, h, h_kv, d, dtype = (c["b"], c["t"], c["tk"], c["h"],
                                       c["h_kv"], c["d"], c["dtype"])

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)

        q, do = rnd(b, t, h, d), rnd(b, t, h, d)
        k, v = rnd(b, tk, h_kv, d), rnd(b, tk, h_kv, d)
        seg_q = seg_k = None
        if c["seg"]:
            cuts = torch.randint(0, 512, (b, t), generator=gen, device=dev)
            seg_q = seg_k = (torch.cumsum((cuts == 0).to(torch.int32),
                                          dim=1).to(torch.int32)
                             .contiguous())
        out, lse, pairs = block_forward(fa, q, k, v, c["q_off"],
                                        c["k_off"], c["window"],
                                        c["k_end"], seg_q, seg_k)
        delta = fa.attention_delta(do, out)
        del out
        kw = dict(causal=True, window=c["window"], k_valid_end=c["k_end"],
                  q_segments=seg_q, k_segments=seg_k)
        args = (q, k, v, do, delta, lse, c["q_off"], c["k_off"])
        before = flash_routes(fa)
        dq = fa.flash_bwd_dq(*args, **kw)
        dk, dv = fa.flash_bwd_dkv(*args, **kw)
        route = "tc" if dtype == bf else "f32"
        took = {n: flash_routes(fa)[n] - before[n] for n in before
                if n.startswith("flash_bwd")}
        if took != {n: int(n.endswith(route)) for n in took}:
            fail(f"K3/K4 at {c} took the routes {took}")
        kw_plain = dict(kw)
        del kw_plain["causal"]
        plain_bwd = (fa.flash_block_grads_reference if dtype == bf
                     else fa.attention_block_grads)
        grads = {"dq": dq, "dk": dk, "dv": dv}

        def gaps(ref):
            return {n: ((grads[n] - want).abs().max().item(),
                        want.abs().max().item())
                    for n, want in zip(grads, ref)}

        for name, got in grads.items():
            if not torch.isfinite(got).all():
                fail(f"K3/K4 non-finite {name} at {c}")
        errs = gaps(plain_bwd(*args, True, d ** -0.5, **kw_plain))
        oracle = (gaps(fa.attention_block_grads(*args, True, d ** -0.5,
                                                **kw_plain))
                  if dtype == bf else {})
        torch.cuda.synchronize()
        ms_dq = cuda_ms(lambda: fa.flash_bwd_dq(*args, **kw), iters=5,
                        warmup=1)
        ms_dkv = cuda_ms(lambda: fa.flash_bwd_dkv(*args, **kw), iters=5,
                         warmup=1)
        plain_ms = cuda_ms(lambda: plain_bwd(
            *args, True, d ** -0.5, **kw_plain), iters=3, warmup=1)
        plain = (c["window"] is None and not c["seg"] and c["q_off"] == 0
                 and c["k_off"] == 0 and t == tk)
        lib_fn = None
        if plain:
            lib_fn = sdpa_bwd_fn(q, k, v, do)
        elif dtype == f32:
            # the f32 card steps' shape: causal and segments as one
            # boolean mask
            lib_fn = sdpa_bwd_fn(q, k, v, do, fa.block_mask(
                t, tk, c["q_off"], c["k_off"], True, c["window"],
                c["k_end"], seg_q, seg_k, q.device))
        lib_ms = cuda_ms(lib_fn, iters=5, warmup=1) if lib_fn else None
        seg = c["seg"]
        b_dq = bwd_bound(b, t, tk, h, h_kv, d, dtype, pairs, seg, 3, 1)
        b_dkv = bwd_bound(b, t, tk, h, h_kv, d, dtype, pairs, seg, 4, 2)
        ok = all(e <= BWD_TOL * max(1.0, m) for e, m in errs.values())
        ok_oracle = all(e <= BWD_BF16_ORACLE_TOL * max(1.0, m)
                        for e, m in oracle.values())
        label = (f"B={b} Tq={t} Tk={tk} H={h} Hkv={h_kv} D={d} "
                 f"window={c['window']} seg={seg} q_off={c['q_off']} "
                 f"k_off={c['k_off']} k_valid_end={c['k_end']} "
                 f"{str(dtype).removeprefix('torch.')} route={route}")
        vs_oracle = (" vs the f32 oracle: " + " ".join(
            f"{n} max|d|={e:.3g}" for n, (e, _) in oracle.items())
            + f" (tol {BWD_BF16_ORACLE_TOL} x max(1, max|ref|)) "
            f"{'ok' if ok_oracle else 'FAIL'};" if oracle else "")
        print(f"K3/K4 {label}: vs {plain_bwd.__name__}: "
              + " ".join(f"{n} max|d|={e:.3g} (max|ref| {m:.3g})"
                         for n, (e, m) in errs.items())
              + f" (tol {BWD_TOL} x max(1, max|ref|));{vs_oracle}"
              f" K3_ms={ms_dq:.4f} "
              f"K4_ms={ms_dkv:.4f} plain_ms(dq,dk,dv)={plain_ms:.4f} "
              f"library_ms(sdpa backward)={fmt(lib_ms)} "
              f"K3_bound_us={b_dq[0] * 1e3:.2f} ({b_dq[1]}) "
              f"K4_bound_us={b_dkv[0] * 1e3:.2f} ({b_dkv[1]}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"K3/K4 disagree with their plain version at {c}")
        if not ok_oracle:
            fail(f"bf16 K3/K4 stray from the f32 oracle at {c}")
        if c is full or dtype == f32:
            shape = ("B=8 T=2048 (main path)" if c is full else
                     f"B={b} T={t} segments f32 (the CUDA-core route)")
            plain_fn = (lambda a=args, k2=kw_plain, dd=d, fn=plain_bwd:
                        fn(*a, True, dd ** -0.5, **k2))
            probes["K3"][shape] = dict(
                kernel=lambda a=args, k2=kw: fa.flash_bwd_dq(*a, **k2),
                plain=plain_fn, library=lib_fn)
            probes["K4"][shape] = dict(
                kernel=lambda a=args, k2=kw: fa.flash_bwd_dkv(*a, **k2),
                plain=plain_fn, library=lib_fn)
        if c is full:
            rows["K3"] = dict(max_abs_err=errs["dq"][0], ms=ms_dq,
                              plain_ms=plain_ms, bound_ms=b_dq[0],
                              bound_by=b_dq[1], library_ms=lib_ms)
            rows["K4"] = dict(max_abs_err=max(errs["dk"][0],
                                              errs["dv"][0]),
                              ms=ms_dkv, plain_ms=plain_ms,
                              bound_ms=b_dkv[0], bound_by=b_dkv[1],
                              library_ms=lib_ms)
    return rows["K3"], rows["K4"], probes


def moe_heavy_config(**kw):
    """The JAX package's MoE shape (tools/bench_moe.py ``heavy``): vocab
    1024, d_model 512, 4 layers, 4 heads, d_head 64, d_ff 4096, 16
    experts, top_k 2, max_seq 1024, bf16; gmm dispatch."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        TransformerConfig)
    fields = dict(vocab=1024, d_model=512, n_layers=4, n_heads=4,
                  d_head=64, d_ff=4096, n_experts=16, top_k=2,
                  max_seq=1024, dtype=torch.bfloat16, moe_dispatch="gmm")
    fields.update(kw)
    return TransformerConfig(**fields)


def gmm_layouts(gen, rows: int, e: int, bm: int, d: int) -> dict:
    """Padded group sizes (int64 on the card, as the routing layer makes
    them) of the four layouts the grouped-matmul checks run: the
    router's own top-2 routing of seeded activations, every row to one
    expert, experts 4-11 empty, and half the rows (a long dead tail)."""
    dev = torch.device("cuda")
    xt = torch.randn((rows // 2, d), generator=gen, device=dev)
    router = torch.randn((d, e), generator=gen, device=dev) * d ** -0.5
    ids = torch.topk(xt @ router, 2, dim=-1).indices.reshape(-1)
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, ids, torch.ones_like(ids))
    one = torch.zeros(e, dtype=torch.long, device=dev)
    one[3] = rows
    holes = torch.full((e,), rows // 8, dtype=torch.long, device=dev)
    holes[4:12] = 0
    half = torch.full((e,), rows // (2 * e), dtype=torch.long, device=dev)
    return {name: ((c + bm - 1) // bm) * bm for name, c in (
        ("router", counts), ("one expert", one), ("empty 4-11", holes),
        ("dead tail", half))}


def gmm_bound(live: int, m: int, k: int, n: int, used: int, es: int,
              dw: bool, e: int) -> tuple[float, str]:
    """Least time for one grouped matmul from this run's data: the live
    rows' 2*K*N flops over the bf16 (or f32) peak; bytes: K5 reads the
    live rows of x and the experts that have rows and writes all M rows
    of out; K6 reads the live rows of x and dy and writes the E f32
    expert gradients."""
    flops = 2 * live * k * n
    if dw:
        nbytes = live * (k + n) * es + e * k * n * 4
    else:
        nbytes = live * k * es + used * k * n * es + m * n * es
    peak = H100_BF16_FLOPS if es == 2 else H100_F32_FLOPS
    t_b, t_f = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def grouped_mm_fn(a, b, group_sizes, dw: bool):
    """``(callable, None)`` of one PyTorch call computing the same
    grouped product (``torch._grouped_mm`` with cumulative offsets;
    yardstick only, never called by the port), or ``(None, reason)``."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm is absent from this PyTorch"
    offs = torch.cumsum(group_sizes, 0).to(torch.int32)
    call = ((lambda: fn(a.t(), b, offs=offs)) if dw
            else (lambda: fn(a, b, offs=offs)))
    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as exc:
        return None, f"torch._grouped_mm refused: {str(exc)[:120]}"
    return call, None


def phase_gmm(gm) -> tuple[dict, dict, dict]:
    """K5 (gmm, plain and transposed read) and K6 (gmm dw) against their
    plain versions at the moe_heavy shapes: 18,432 static rows, E=16,
    block_m 128, d 512, f 4096, for both expert matrices, in bf16 (K5
    and K6 on the tensor-core route) and f32 (the CUDA-core route), over
    four group layouts; bf16 K6 is timed at the hot expert beside the
    router layout.  Returns the kernels-line rows of K5
    and K6 at the main path's case (router layout, bf16, w_in side),
    and, by case, callables of the kernel, its plain version and the
    library call for the device-time phase."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    cfg = moe_heavy_config()
    e, d, f, bm = cfg.n_experts, cfg.d_model, cfg.d_ff, 128
    rows = MOE_B * MOE_T * cfg.top_k                      # 16,384 routed
    m = rows + e * bm                                     # static bound
    layouts = gmm_layouts(gen, rows, e, bm, d)
    rows_out, probes = {}, {"K5": {}, "K6": {}}
    dw_times = {}   # bf16 K6 kernel ms by (label, layout)
    for dtype in (torch.bfloat16, torch.float32):
        tol5 = GMM_TOL[dtype]
        es = torch.tensor([], dtype=dtype).element_size()
        w_in = (torch.randn((e, d, f), generator=gen, device=dev)
                * d ** -0.5).to(dtype)
        w_out = (torch.randn((e, f, d), generator=gen, device=dev)
                 * f ** -0.5).to(dtype)
        for name, gs in layouts.items():
            live = int(gs.sum())
            used = int((gs > 0).sum())
            mask = (torch.arange(m, device=dev) < live)[:, None]

            def rnd(cols):
                return (torch.randn((m, cols), generator=gen, device=dev)
                        * mask).to(dtype)

            x, h, dy_h, dy_x = rnd(d), rnd(f), rnd(f), rnd(d)
            cases = (
                ("K5 w_in", "fwd", (x, w_in, False), f),
                ("K5 w_out", "fwd", (h, w_out, False), d),
                ("K5 dx w_in^T", "fwd", (dy_h, w_in, True), d),
                ("K5 dx w_out^T", "fwd", (dy_x, w_out, True), f),
                ("K6 dw_in", "dw", (x, dy_h), None),
                ("K6 dw_out", "dw", (h, dy_x), None),
            )
            bf16 = dtype == torch.bfloat16
            main_layout = name == "router" and bf16
            for label, kind, args, n_out in cases:
                if kind == "fwd":
                    a, w, tr = args
                    kernel = (lambda a=a, w=w, tr=tr, gs=gs:
                              gm.gmm_forward(a, w, gs, bm, transpose_w=tr))
                    plain = (lambda a=a, w=w, tr=tr, gs=gs:
                             gm.gmm_reference(a, w, gs, bm, transpose_w=tr))
                    k_dim, n_dim, tol = a.shape[1], n_out, tol5
                    bound = gmm_bound(live, m, k_dim, n_dim, used, es,
                                      False, e)
                    lib_b = w.transpose(1, 2) if tr else w
                else:
                    a, dy = args
                    kernel = (lambda a=a, dy=dy, gs=gs:
                              gm.gmm_dw(a, dy, gs, bm))
                    plain = (lambda a=a, dy=dy, gs=gs:
                             gm.gmm_dw_reference(a, dy, gs, bm))
                    k_dim, n_dim, tol = a.shape[1], dy.shape[1], DW_TOL
                    bound = gmm_bound(live, m, k_dim, n_dim, used, es,
                                      True, e)
                    lib_b = dy
                # K5 and K6 alike: bf16 on the tensor cores, f32 on the
                # CUDA cores
                counter = "tc_launches" if kind == "fwd" else "dw_tc_launches"
                before = getattr(gm, counter)
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if getattr(gm, counter) != before + bf16:
                    fail(f"{label} took the wrong route at {name} {dtype}")
                if not torch.isfinite(got.float()).all():
                    fail(f"{label} non-finite output at {name} {dtype}")
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1.0, want.float().abs().max().item())
                # K5: the dead tail's rows; K6: experts without rows
                zeros = got[gs == 0] if kind == "dw" else got[live:]
                dead_ok = int(torch.count_nonzero(zeros)) == 0
                ok = err <= tol * scale and dead_ok
                direct = ""
                if kind == "dw" and bf16:
                    # the backward's form: bf16 written from the
                    # accumulators must be the f32 output rounded
                    same = torch.equal(gm.gmm_dw(a, dy, gs, bm,
                                                 out_dtype=torch.bfloat16),
                                       got.to(torch.bfloat16))
                    ok = ok and same
                    direct = f" bf16 out == f32 out rounded: {same}"
                ms = plain_ms = lib_ms = lib = lib_err = None
                why = "not timed at this layout"
                hot = kind == "dw" and bf16 and name == "one expert"
                if name == "router" or hot:
                    ms = trusted(label, "kernel_ms", cuda_ms(
                        kernel, iters=5, warmup=1), bound[0], kernel)
                    plain_ms = cuda_ms(plain, iters=3, warmup=1)
                    lib, why = grouped_mm_fn(a, lib_b, gs, kind == "dw")
                    if lib:
                        ref = want if kind == "dw" else want[:live]
                        res = lib() if kind == "dw" else lib()[:live]
                        lib_err = (res.float() - ref.float()).abs().max()
                        lib_ms = trusted(label, "library_ms", cuda_ms(
                            lib, iters=5, warmup=1), bound[0], lib)
                        del res, ref
                    if kind == "dw" and bf16:
                        dw_times[(label, name)] = ms
                route = "tensor cores" if bf16 else "CUDA cores"
                print(f"{label} M={m} K={k_dim} N={n_dim} E={e} bm={bm} "
                      f"live={live} ({name}) "
                      f"{str(dtype).removeprefix('torch.')} ({route}): "
                      f"max|d|={err:.3g} (tol {tol} x max(1, max|plain| "
                      f"{scale:.3g})) zeros kept={dead_ok}{direct} "
                      f"kernel_ms={fmt(ms)} plain_ms={fmt(plain_ms)} "
                      f"library_ms="
                      f"{fmt(lib_ms) if lib else 'none: ' + why}"
                      + (f" (library max|d| {float(lib_err):.3g})"
                         if lib_err is not None else "")
                      + f" bound_us={bound[0] * 1e3:.2f} ({bound[1]}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"{label} disagrees with its plain version at "
                         f"{name} {dtype}")
                if hot:
                    probes["K6"][f"{label} one expert bf16"] = dict(
                        kernel=kernel)
                if main_layout:
                    main = label in ("K5 w_in", "K6 dw_in")
                    shape = f"{label} router bf16" + (" (main path)" if main
                                                      else "")
                    probes[label[:2]][shape] = dict(
                        kernel=kernel, plain=plain,
                        **({"library": lib} if lib else {}))
                    if main:
                        rows_out[label[:2]] = dict(
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound[0], bound_by=bound[1],
                            library_ms=lib_ms)
                del got, want
    for label in ("K6 dw_in", "K6 dw_out"):
        one, router = (dw_times[(label, n)] for n in ("one expert",
                                                      "router"))
        print(f"{label} bf16 kernel_ms: one expert {fmt(one)} against "
              f"the router layout's {fmt(router)}"
              + (f" ({one / router:.2f}x)" if one and router else ""),
              flush=True)
    return rows_out["K5"], rows_out["K6"], probes


def int8_bound(g: int, m: int, k: int, n: int, es: int, x_rows: int,
               peak: float) -> tuple[float, str]:
    """Least time for one int8 product: x (``x_rows`` rows of K: M, or
    G * M when every expert reads its own x) in its dtype, the G int8
    weights, their f32 scales and the output read or written once, over
    the memory rate; 2*K flops per output element over ``peak``."""
    nbytes = x_rows * k * es + g * k * n + g * n * 4 + g * m * n * es
    t_b, t_f = nbytes / H100_BYTES_PER_S, 2 * g * m * k * n / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def int8pack_fn(x, q, scale):
    """``(callable, None)`` of ``torch._weight_int8pack_mm`` (weight
    [N, K] int8, scales [N]: the same W8A16 function; yardstick only,
    never called by the port), or ``(None, reason)``."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, "torch._weight_int8pack_mm is absent from this PyTorch"
    w_nk = q.t().contiguous()
    sc = scale.reshape(-1).to(x.dtype)
    try:
        fn(x, w_nk, sc)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError, NotImplementedError) as exc:
        return None, f"torch._weight_int8pack_mm refused: {str(exc)[:120]}"
    return (lambda: fn(x, w_nk, sc)), None


def int8_cases() -> list:
    """(kind, M, K, N, label) of the K7 checks: the 154M decode step's
    products (wq/wo 1024x1024, wk/wv 1024x256, w_in, w_out, the
    unembedding) at 1, 8 and 64 slots; the 660M model's MLP at 8 rows
    (tools/bench_int8.py:39); 96 and 768 rows past the M <= 64 gate; a
    ragged shape; moe_heavy's expert products at 8 rows (E = 16)."""
    cases = [("K7a", m, k, n, "154M")
             for m in (1, 8, 64)
             for k, n in ((1024, 1024), (1024, 256), (1024, 4096),
                          (4096, 1024), (1024, 32000))]
    cases += [("K7a", 8, 2048, 8192, "660M"), ("K7a", 8, 8192, 2048, "660M"),
              ("K7a", 96, 1024, 4096, "off-gate"),
              ("K7a", 768, 1024, 4096, "off-gate"),
              ("K7a", 5, 1000, 333, "ragged"),
              ("K7b", 8, 512, 4096, "moe_heavy w_in, x shared by 16 experts"),
              ("K7b", 8, 4096, 512, "moe_heavy w_out, transposed view")]
    return cases


def phase_int8(qm) -> tuple[dict, dict, dict]:
    """K7a and K7b against their plain versions over ``int8_cases`` in
    bf16 and f32, timed with the L2 flushed before every call.  Returns
    the kernels-line rows at the main paths' cases (K7a: the 154M
    unembedding at 8 slots, bf16; K7b: the shared-x up-projection at
    moe_heavy, f32, as the int8 MoE drain runs it) and, by case,
    callables for the device-time phase."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    e = 16
    rows, probes = {}, {"K7a": {}, "K7b": {}}
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.tensor([], dtype=dtype).element_size()
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
        name = str(dtype).removeprefix("torch.")
        for kind, m, k, n, label in int8_cases():
            g = e if kind == "K7b" else 1
            w = torch.randn((g, k, n), generator=gen, device=dev) * k ** -0.5
            qt = qm.quantize(w, (1,))                 # scale [g, 1, n]
            del w
            q_bf = qt.q.to(torch.bfloat16)
            if kind == "K7a":
                q2, s2 = qt.q[0], qt.scale[0]
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                kernel = (lambda x=x, q2=q2, s2=s2:
                          qm.int8_matmul(x, q2, s2))
                plain = (lambda x=x, q2=q2, s2=s2:
                         qm.int8_matmul_reference(x, q2, s2))
                xb, wb = x.to(torch.bfloat16), q_bf[0]
                cublas = lambda xb=xb, wb=wb: torch.matmul(xb, wb)
                lib, why = int8pack_fn(x, q2, s2)
                x_rows = m
            else:
                shared = k == 512
                if shared:     # btd,edf->btef: one x, stride 0 over experts
                    x = torch.randn((m, k), generator=gen,
                                    device=dev).to(dtype)
                    x3 = x[None].expand(g, m, k)
                else:          # btef,efd->bted: [rows, experts, f] read
                    x = torch.randn((m, g, k), generator=gen,
                                    device=dev).to(dtype)
                    x3 = x.permute(1, 0, 2)
                y = torch.empty((m, g, n), dtype=dtype, device=dev)
                kernel = (lambda x3=x3, qt=qt, y=y: qm.int8_bmm(
                    x3, qt.q, qt.scale, out=y.permute(1, 0, 2)))
                plain = (lambda x3=x3, qt=qt:
                         qm.int8_bmm_reference(x3, qt.q, qt.scale))
                xb = x3.to(torch.bfloat16).contiguous()
                cublas = lambda xb=xb, wb=q_bf: torch.bmm(xb, wb)
                if shared:     # one W8A16 product on the [K, E*N] weight
                    lib, why = int8pack_fn(
                        x, qt.q.permute(1, 0, 2).reshape(k, g * n),
                        qt.scale.reshape(g * n))
                else:
                    lib, why = None, ("each expert reads its own x: no "
                                      "single PyTorch call computes a "
                                      "batched W8A16 product")
                x_rows = m if shared else g * m
            route = qm.int8_route(dtype)
            plan = qm.pick_int8_tiles(g, m, k, n, dtype,
                                      batched=kind == "K7b")
            before = qm.tc_launches
            out, want = kernel(), plain()
            torch.cuda.synchronize()
            if qm.tc_launches != before + (route == "tensor_cores"):
                fail(f"{kind} took the wrong route at M={m} K={k} N={n} "
                     f"{name}")
            if not torch.isfinite(out.float()).all():
                fail(f"{kind} non-finite output at M={m} K={k} N={n} {name}")
            err = (out.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            tol = INT8_TOL[dtype]
            ok = err <= tol * scale
            bound = int8_bound(g, m, k, n, es, x_rows, peak)
            shape = (f"M={m} K={k} N={n}" + (f" E={g}" if g > 1 else "")
                     + f" ({label}) {name}")
            ms = trusted(f"{kind} {shape}", "kernel_ms", cold_ms(kernel),
                         bound[0], kernel)
            plain_ms = cold_ms(plain, iters=5, warmup=1)
            cublas_ms = cold_ms(cublas)
            lib_ms = (trusted(f"{kind} {shape}", "library_ms", cold_ms(lib),
                              bound[0], lib) if lib else None)
            print(f"{kind} {shape} ({route.replace('_', ' ')}; "
                  f"{plan.splits} splits of {plan.k_chunk} rows, "
                  f"{plan.blocks} blocks, ring {plan.ring}): "
                  f"max|d|={err:.3g} (tol {tol} x max(1, max|plain| "
                  f"{scale:.3g})) kernel_ms={fmt(ms)} plain_ms="
                  f"{plain_ms:.4f} cublas_bf16_ms={cublas_ms:.4f} "
                  f"library_ms={fmt(lib_ms) if lib else 'none: ' + why} "
                  f"bound_us={bound[0] * 1e3:.2f} ({bound[1]}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{kind} disagrees with its plain version at {shape}")
            main = ((kind, m, k, n, dtype) == ("K7a", 8, 1024, 32000,
                                                torch.bfloat16)
                    or (kind, k, dtype) == ("K7b", 512, torch.float32))
            probe = {"kernel": kernel}
            if main:
                probe.update(plain=plain, cublas_bf16=cublas,
                             **({"library": lib} if lib else {}))
                rows[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound[0], bound_by=bound[1],
                                  library_ms=lib_ms)
            probes[kind][shape + (" (main path)" if main else "")] = probe
            del out, want
    return rows["K7a"], rows["K7b"], probes


def serving_config():
    """The 154M configuration: vocab 32000, d_model 1024, 8 layers, 16
    heads, 4 KV heads, d_head 64, d_ff 4096, max_seq 2048, bf16."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        TransformerConfig)
    return TransformerConfig(vocab=32000, d_model=1024, n_layers=8,
                             n_heads=16, n_kv_heads=4, d_head=64,
                             d_ff=4096, max_seq=2048, dtype=torch.bfloat16)


def serving_model():
    """(cfg, params): the 154M serving configuration at full width and
    depth in bf16, random weights from generator seed 0 on the card."""
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    cfg = serving_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    n_params = sum(p.numel() for p in param_tensors(params))
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


#: dispatch labels of the decode layer's forward passes: the decode
#: steps (one row per slot, so at most 8 rows) and the prefills (any
#: number of rows); every forward pass of a drain carries one of them
DECODE_PASSES = ("decode_step_rows", "paged_decode_step_rows")
PREFILL_PASSES = ("prefill", "prefill_suffix", "prefill_adopt_rows",
                  "suffix_fill_adopt")


def k7_passes(launched: int, per_pass: int, passes, label: str) -> int:
    """The forward passes that went through K7: ``launched`` launches
    of ``per_pass`` each.  Fails unless that division is exact and its
    quotient lies between the drain's decode steps (each of at most 64
    rows, so each must go through K7) and all its forward passes."""
    decode, prefill = passes
    n, rest = divmod(launched, per_pass)
    if rest or not decode <= n <= decode + prefill:
        fail(f"{label}: {launched} launches are not {per_pass} per pass "
             f"over between {decode} decode steps and {decode + prefill} "
             f"forward passes")
    return n


def drain(engine_cls, params, cfg, reqs, fa, pa, label, **kw):
    """Drive one engine over ``reqs`` with the kernel counters zeroed
    just before and read just after; returns (finished, counts, stats,
    passes): ``passes`` is (decode passes, prefills), the decode
    layer's forward passes by dispatch label, the fused block's passes
    (its graphs' replayed steps and warm-ups) counted as decode
    passes.  ``stats`` adds the run's wall seconds, generated tokens,
    decode steps, dispatches plus readbacks, the graphs' draft-model
    passes (``draft_passes``) and, under ``run``, the change of every
    ``..._total`` counter over the run, to the engine's.

    A step engine (``chain_steps`` 1) warms up on a separate engine; a
    fused engine drains the traffic once before the measured run on
    the same engine, so that every graph the run replays is captured
    before it."""
    from k8s_dra_driver_tpu_torch.models import quant as qm
    from k8s_dra_driver_tpu_torch.utils import dispatch
    fused = kw.get("chain_steps", 1) > 1
    warm = engine_cls(params, cfg, slots=8, **kw)
    for r in reqs if fused else reqs[:2]:
        warm.submit(r if fused else type(r)(uid="w" + r.uid,
                                            prompt=r.prompt, max_new=2))
    warm.run()
    eng = warm if fused else engine_cls(params, cfg, slots=8, **kw)
    del warm
    for r in reqs:
        eng.submit(r)
    graphs = eng._graphs

    def graph_counts():
        return ((0, 0, 0) if graphs is None else
                (graphs.passes, graphs.replays, graphs.draft_passes))

    before = graph_counts()
    stats0 = eng.stats()
    torch.cuda.synchronize()
    fa.launches = fa.tc_launches = 0
    pa.launches = 0
    for name in qm.launches:
        qm.launches[name] = 0
    qm.tc_launches = 0
    t0 = time.perf_counter()
    with dispatch.track() as t:
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require_fwd_route(fa, label, cfg.dtype == torch.bfloat16)
    # K7 takes x in the model's dtype: every launch on its route
    k7 = sum(qm.launches.values())
    if qm.tc_launches != (k7 if cfg.dtype == torch.bfloat16 else 0):
        fail(f"{label}: {qm.tc_launches} of {k7} K7 launches on the "
             f"tensor-core route, expected "
             f"{'all' if cfg.dtype == torch.bfloat16 else 'none'}")
    counts = {"flash_fwd": fa.launches, "flash_fwd_tc": fa.tc_launches,
              "paged_decode": pa.launches, **qm.launches,
              "int8_tc": qm.tc_launches}
    passes = tuple(sum(t.by_label.get(k, 0) for k in labels)
                   for labels in (DECODE_PASSES, PREFILL_PASSES))
    after = graph_counts()
    passes = (passes[0] + after[0] - before[0], passes[1])
    stats = eng.stats()
    gen_tokens = sum(len(f.tokens) - f.n_prompt for f in done)
    steps = stats["decode_steps_total"] - stats0["decode_steps_total"]
    stats.update(wall_s=wall, generated=gen_tokens, steps=steps,
                 replays=after[1] - before[1],
                 draft_passes=after[2] - before[2],
                 dispatches_readbacks=t.dispatches + t.readbacks,
                 by_label=t.by_label,
                 run={k: v - stats0[k] for k, v in stats.items()
                      if k.endswith("_total")})
    if len(done) != len(reqs):
        fail(f"{label}: {len(done)} of {len(reqs)} requests finished")
    print(f"engine {label}: {len(done)} finished, {gen_tokens} tokens in "
          f"{wall:.3f} s = {gen_tokens / wall:.1f} tokens/s, "
          f"{1e3 * wall / max(steps, 1):.3f} ms per decode step and "
          f"{1e3 * wall / max(gen_tokens, 1):.4f} ms per token (wall), "
          f"kernel launches {counts}", flush=True)
    print(f"engine {label} stats: {json.dumps(stats)}", flush=True)
    return done, counts, stats, passes


def phase_int8_serving(params, cfg, reqs, fa, pa) -> dict:
    """int8 serving at 154M: ``quantize_params`` of the bf16 weights held
    to them on one 8 x 96 forward, then the three int8 drains, each with
    its teacher-forced check against a full forward on the int8 weights
    and 6 K7a launches per layer + 1 for each pass K7 serves (see
    :func:`k7_passes`).  Returns the drains' summed launches."""
    from k8s_dra_driver_tpu_torch.models.quant import (quantize_params,
                                                       quantized_bytes)
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import forward
    qparams = quantize_params(params, cfg)
    stored, full = quantized_bytes(qparams)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (8, 96)), device="cuda")
    with torch.no_grad():
        ref = forward(params, toks, cfg).float()
        got = forward(qparams, toks, cfg).float()
    rel = float(((got - ref).abs() / ref.std().clamp_min(1e-6)).mean())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    ok = rel < QUANT_MEAN_REL and agree > QUANT_AGREE
    print(f"quantize_params 154M: {stored} bytes stored against {full} in "
          f"bf16 ({stored / full:.3f}); one B=8 T=96 forward, int8 vs bf16 "
          f"weights: mean |d| / std {rel:.4f} (< {QUANT_MEAN_REL}), argmax "
          f"agreement {agree:.4f} (> {QUANT_AGREE}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("quantized logits do not track the full-precision ones")
    per_pass = 6 * cfg.n_layers + 1
    total = {}
    for label, c, kw in (
            ("int8 weights, contiguous", cfg, {}),
            ("int8 weights, contiguous int8 KV",
             dataclasses.replace(cfg, kv_cache_dtype="int8"), {}),
            ("int8 weights, paged", cfg, {"kv_layout": "paged"})):
        done, counts, _, passes = drain(ServingEngine, qparams, c, reqs,
                                        fa, pa, label, top_k=50, **kw)
        paged = "kv_layout" in kw
        if (counts["int8_bmm"] or counts["flash_fwd"] <= 0
                or paged != (counts["paged_decode"] > 0)):
            fail(f"{label}: launches {counts}, expected no K7b, K1 and "
                 f"(paged only) K2")
        n = k7_passes(counts["int8_matmul"], per_pass, passes, label)
        worst = teacher_forced(qparams, cfg, done, reqs)
        print(f"teacher-forced ({label}; the forward over the full "
              f"sequence, at least 72 rows, takes the einsum route): worst "
              f"gap {worst:.4f} <= {TF_MARGIN}; K7a launched "
              f"{counts['int8_matmul']} = {per_pass} x {n} passes of at "
              f"most 64 rows: {passes[0]} decode steps + {n - passes[0]} "
              f"of {passes[1]} prefills", flush=True)
        for name, k in counts.items():
            total[name] = total.get(name, 0) + k
    return total


def phase_int8_moe_serving(fa, pa) -> dict:
    """The moe_heavy drain of ``phase_moe_serving`` on ``quantize_params``
    weights, in f32, dense dispatch (the only one int8 experts take),
    with its teacher-forced check; for each pass K7 serves, K7b twice
    per layer (the expert products) and K7a 4 per layer + 1, over the
    same passes.  Returns the drain's launches."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    cfg = moe_heavy_config(dtype=torch.float32, moe_dispatch="dense")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")
    qparams = quantize_params(params, cfg)
    del params
    reqs = s8_r24(cfg.vocab)
    label = "moe_heavy f32 int8 weights, contiguous"
    done, counts, _, passes = drain(ServingEngine, qparams, cfg, reqs, fa,
                                    pa, label, top_k=50)
    n = k7_passes(counts["int8_matmul"], 4 * cfg.n_layers + 1, passes,
                  label + " (K7a)")
    if (k7_passes(counts["int8_bmm"], 2 * cfg.n_layers, passes,
                  label + " (K7b)") != n or counts["flash_fwd"] <= 0):
        fail(f"int8 MoE drain launched {counts}: K7a and K7b over "
             f"different passes, or no K1")
    worst = teacher_forced(qparams, cfg, done, reqs)
    print(f"teacher-forced (moe_heavy f32 int8 weights, dense dispatch, "
          f"einsum route): worst gap {worst:.4f} <= {TF_MARGIN}; K7a "
          f"{counts['int8_matmul']}, K7b {counts['int8_bmm']} launches over "
          f"{n} passes of at most 64 rows: {passes[0]} decode steps + "
          f"{n - passes[0]} of {passes[1]} prefills", flush=True)
    return counts


#: the fused engine's block length: the JAX package's serving probe
#: drains s8_r24 at chain_steps=47 (bench.py:1222,
#: tools/bench_serving.py:53)
FUSED_CHAIN = 47
#: a fused drain pays at least this many times fewer host dispatches
#: plus readbacks per generated token than the step engine on the same
#: traffic: the JAX package's gate (tests/test_decode.py:426-452)
FUSED_AMORTIZATION = 8


def phase_fused_serving(params, cfg, reqs, fa, pa) -> dict:
    """Fused generation blocks on the card: each variant drains s8_r24
    twice in this call, on the step engine and at ``chain_steps`` =
    FUSED_CHAIN, where every block is one replay of a captured CUDA
    graph.  Variants: the 154M on bf16 weights (K1 for the fills,
    outside the graph), on ``quantize_params`` weights (K7a inside the
    graph, tensor-core route) with the contiguous cache and with the
    contiguous int8 KV cache, and the moe_heavy drain in f32 (dense
    dispatch; no K7).  Gates: f32 streams byte-equal to the step
    engine's; bf16 greedy streams within TF_MARGIN teacher-forced (the
    byte-equal count printed); K7 launches exact, those inside the
    graphs included; no block outside a graph; dispatches plus
    readbacks per token at least FUSED_AMORTIZATION times fewer.
    Returns the fused drains' summed launches, and the 154M drains'
    (finished, stats) by "bf16 step", "bf16 fused", "int8 step" and
    "int8 fused", which the speculative phase compares with."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    qparams = quantize_params(params, cfg)
    refs = {}
    moe_cfg = moe_heavy_config(dtype=torch.float32)
    moe_params = init_params(moe_cfg, torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
    per_pass = 6 * cfg.n_layers + 1
    total: dict = {}
    summary = []
    for label, p, c, r in (
            ("154M bf16 weights, contiguous", params, cfg, reqs),
            ("154M int8 weights, contiguous", qparams, cfg, reqs),
            ("154M int8 weights, contiguous int8 KV", qparams,
             dataclasses.replace(cfg, kv_cache_dtype="int8"), reqs),
            ("moe_heavy f32, contiguous", moe_params, moe_cfg,
             s8_r24(moe_cfg.vocab))):
        int8 = p is qparams
        step, _, s_stats, _ = drain(ServingEngine, p, c, r, fa, pa,
                                    f"{label}, chain_steps=1", top_k=50)
        done, counts, stats, passes = drain(
            ServingEngine, p, c, r, fa, pa,
            f"{label}, chain_steps={FUSED_CHAIN}", top_k=50,
            chain_steps=FUSED_CHAIN)
        if c is cfg:
            tag = "int8" if int8 else "bf16"
            refs[f"{tag} step"] = (step, s_stats)
            refs[f"{tag} fused"] = (done, stats)
        blocks = stats["by_label"].get("decode_fused_rows", 0)
        stray = [k for k in DECODE_PASSES if stats["by_label"].get(k)]
        if stray or blocks <= 0 or blocks != stats["replays"]:
            fail(f"{label}: {blocks} blocks, {stats['replays']} graph "
                 f"replays, decode labels {stray}: every block must be "
                 f"one graph replay")
        if counts["flash_fwd"] <= 0 or counts["int8_bmm"] \
                or bool(counts["int8_matmul"]) != int8:
            fail(f"{label}: launches {counts}, expected K1 and "
                 f"{'K7a' if int8 else 'no K7'}")
        if int8:
            n = k7_passes(counts["int8_matmul"], per_pass, passes, label)
            print(f"{label}: K7a launched {counts['int8_matmul']} = "
                  f"{per_pass} x {n} passes: {passes[0]} decode passes "
                  f"(in {blocks} graph replays) + "
                  f"{n - passes[0]} of {passes[1]} prefills", flush=True)
        by_uid = {f.uid: f.tokens for f in step}
        same = sum(np.array_equal(f.tokens, by_uid[f.uid]) for f in done)
        if c.dtype == torch.float32:
            if same != len(done):
                fail(f"{label}: {len(done) - same} f32 streams differ from "
                     f"the step engine's")
        else:
            worst = teacher_forced(p, c, done, r)
            print(f"teacher-forced ({label}, fused): worst gap "
                  f"{worst:.4f} <= {TF_MARGIN}", flush=True)
        per_tok = (s_stats["dispatches_readbacks"] / s_stats["generated"],
                   stats["dispatches_readbacks"] / stats["generated"])
        if per_tok[0] < FUSED_AMORTIZATION * per_tok[1]:
            fail(f"{label}: {per_tok[1]:.4f} dispatches + readbacks per "
                 f"token fused against {per_tok[0]:.4f} stepwise: not "
                 f"{FUSED_AMORTIZATION}x fewer")
        row = {"label": label, "streams_equal": same,
               "streams": len(done),
               "dispatch_readbacks_per_token": per_tok,
               "graphs": stats["graph_captures_total"],
               "capture_s": stats["graph_capture_s"]}
        for key, st in (("step", s_stats), ("fused", stats)):
            row[key] = {
                "tokens_per_s": st["generated"] / st["wall_s"],
                "wall_ms_per_step": 1e3 * st["wall_s"] / max(st["steps"], 1),
                "wall_ms_per_token": 1e3 * st["wall_s"] / st["generated"],
                "decode_steps": st["steps"]}
        print(f"fused {label} ({card_line()}): {same}/{len(done)} streams "
              f"byte-equal to the step engine's; tokens/s "
              f"{row['step']['tokens_per_s']:.1f} -> "
              f"{row['fused']['tokens_per_s']:.1f}; wall ms per decode step "
              f"{row['step']['wall_ms_per_step']:.3f} -> "
              f"{row['fused']['wall_ms_per_step']:.3f}, per token "
              f"{row['step']['wall_ms_per_token']:.4f} -> "
              f"{row['fused']['wall_ms_per_token']:.4f}; dispatches + "
              f"readbacks per token {per_tok[0]:.4f} -> {per_tok[1]:.4f}; "
              f"{row['graphs']} graphs captured in {row['capture_s']:.3f} s, "
              f"{blocks} blocks each one replay", flush=True)
        summary.append(row)
        for name, k in counts.items():
            total[name] = total.get(name, 0) + k
    print(f"fused serving: {json.dumps(summary)}", flush=True)
    return total, refs


#: the speculative drains' draft length: the engines' default, and the
#: JAX package's
SPEC_DRAFT_LEN = 4
#: the f32 self-draft drain's least accept rate: the target drafting
#: for itself accepts every greedy proposal but after a near tie between
#: a 5-row window and one-row steps, and a row's last window emits only
#: what its max_new leaves (about 37 of a row's 40 drafts)
SPEC_SELF_ACCEPT = 0.8
#: total variation between the accept's emitted tokens and the
#: closed-form filtered target distribution at 16384 rows: the bounds
#: of tests/test_speculative.py:166 (first emitted token) and :175 (the
#: bonus token of a full accept)
SPEC_TV_FIRST = 0.03
SPEC_TV_BONUS = 0.05
#: the full-accept share of the accept math's rows, against its closed
#: form prod_i sum_x min(p_i(x), q_i(x)) (binomial spread at 16384 rows
#: is about 0.004)
SPEC_SHARE_TOL = 0.01
#: the step path's speculative launch sites; a fused speculative drain
#: runs none of them (every window is inside a graph)
SPEC_STEP_LABELS = ("decode_window_rows", "paged_window_rows",
                    "draft_propose_rows", "draft_sample_rows",
                    "draft_ngram_rows", "spec_accept_rows")


def spec_row(stats) -> dict:
    """A drain's end-to-end numbers: tokens/s, wall ms a decode step
    (a window, on a speculative engine), decode steps, dispatches plus
    readbacks a token."""
    return {"tokens_per_s": stats["generated"] / stats["wall_s"],
            "wall_ms_per_step": 1e3 * stats["wall_s"] / max(stats["steps"],
                                                            1),
            "steps": stats["steps"],
            "dispatch_readbacks_per_token": (stats["dispatches_readbacks"]
                                             / stats["generated"])}


def same_streams(done, ref) -> int:
    by_uid = {f.uid: f.tokens for f in ref}
    return sum(np.array_equal(f.tokens, by_uid[f.uid]) for f in done)


def phase_spec_accept(dev) -> None:
    """The accept math alone on the card: ``spec_accept_rows`` over
    16384 rows of one fixed window (V=8, K=2, the fixtures of
    tests/test_speculative.py:114-176 drawn with numpy, proposals drawn
    from q by inverse CDF), each row with its own generator, against
    the closed-form filtered target distribution ``p``."""
    from k8s_dra_driver_tpu_torch.models import decode as dm
    v, k, rows, temp = 8, 2, 16384, 0.9
    rng = np.random.default_rng(3)
    tl = rng.normal(size=(k + 1, v)).astype(np.float32)
    dl = rng.normal(size=(k, v)).astype(np.float32)

    def probs(logits, top_k, top_p):
        return torch.softmax(dm._filter_logits(
            torch.as_tensor(logits, device=dev), temp, top_k, top_p), -1)

    def tv(toks, want) -> float:
        emp = np.bincount(toks, minlength=v) / len(toks)
        return 0.5 * float(np.abs(emp - want).sum())

    for name, top_k, top_p, draft in (("no filter", 0, 0.0, dl),
                                      ("top_k 4", 4, 0.0, dl),
                                      ("top_p 0.8", 0, 0.8, dl),
                                      ("perfect draft", 0, 0.0, tl[:k])):
        p, q = probs(tl, top_k, top_p), probs(draft, top_k, top_p)
        u = np.random.default_rng(4).random((rows, k))
        cdf = np.cumsum(q.double().cpu().numpy(), axis=-1)
        props = np.stack([np.minimum(np.searchsorted(cdf[i], u[:, i],
                                                     side="right"), v - 1)
                          for i in range(k)], 1)
        gens = [torch.Generator(device=dev).manual_seed(r)
                for r in range(rows)]
        t0 = time.perf_counter()
        emit, a = dm.spec_accept_rows(
            p.new_tensor(tl)[None].expand(rows, -1, -1),
            torch.as_tensor(props, device=dev), q[None].expand(rows, -1, -1),
            gens, torch.full((rows,), temp, device=dev), top_k, top_p)
        emit, a = emit.cpu().numpy(), a.cpu().numpy()
        wall = time.perf_counter() - t0
        p = p.double().cpu().numpy()
        first = tv(emit[:, 0], p[0])
        full = a == k
        share = float(np.prod(np.minimum(p[:k], q.double().cpu().numpy())
                              .sum(-1)))
        line = (f"spec accept math ({name}, {rows} rows, V={v} K={k}, on "
                f"the card, {wall:.2f} s): first emitted token TV "
                f"{first:.4f} < {SPEC_TV_FIRST}; full accepts "
                f"{full.mean():.4f} against closed form {share:.4f}")
        ok = first < SPEC_TV_FIRST and abs(full.mean() - share) < \
            SPEC_SHARE_TOL
        if name == "no filter":
            bonus = tv(emit[full, k], p[k])
            line += f"; bonus token TV {bonus:.4f} < {SPEC_TV_BONUS}"
            ok &= bonus < SPEC_TV_BONUS
        if name == "perfect draft":
            line += f"; least accepts {int(a.min())} (all {k})"
            ok &= int(a.min()) == k
        print(line + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            fail(f"speculative accept math ({name}) off the target "
                 f"distribution")


def phase_spec_serving(params, cfg, reqs, fa, pa, refs) -> dict:
    """Speculative decoding on the card (``draft_len`` SPEC_DRAFT_LEN,
    engine top_k 50), each drain beside the non-speculative drain of
    this call in ``refs`` ((finished, stats) by name): the n-gram source
    on the contiguous cache step by step and fused (``chain_steps`` =
    FUSED_CHAIN, every block one graph replay); the target as its own
    draft, likewise, on bf16 and on ``quantize_params`` weights (K7a in
    the graph for target and draft); the n-gram source on the paged
    cache, on the full pool and on a 41-block pool with max_seq 256;
    the f32 self-draft step by step beside an f32 plain drain; the
    accept math alone; the ported probe in bf16 and f32.

    Gates: every greedy stream within TF_MARGIN teacher-forced; fused
    drains byte-equal to the step drains of the same source and
    weights, all 24 streams; K1 in every drain; K7a exactly 49 a target
    pass and 49 a draft pass (the graphs' passes counted) in the int8
    drains; no K2 and at least one spec trim in the paged drains, a
    preemption on the small pool; every fused block one graph replay;
    the f32 self-draft accept rate at least SPEC_SELF_ACCEPT; the
    accept math's TV bounds; the probe byte-equal to the closed-form
    ramp.  The streams byte-equal to the non-speculative engine's are
    counted, not gated (a 5-row window and five one-row steps may sum
    in different orders).  Returns the drains' summed launches and
    their (finished, stats) by "spec <label>", which the LoRA phase
    compares with."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.specprobe import spec_decode_probe
    t_phase = time.perf_counter()
    kd = SPEC_DRAFT_LEN
    qparams = quantize_params(params, cfg)
    per_pass = 6 * cfg.n_layers + 1
    ngram = {"draft_source": "ngram"}
    self_bf16 = {"draft_params": params, "draft_cfg": cfg}
    self_int8 = {"draft_params": qparams, "draft_cfg": cfg}
    fused = {"chain_steps": FUSED_CHAIN}
    # a request whose prompt takes at most 64 rows fills through K7: its
    # target fill and its draft fill
    small_fills = 2 * sum(r.prompt.size <= 64 for r in reqs)
    f32 = map_params(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    base32, total, stats32, _ = drain(ServingEngine, f32, cfg32, reqs, fa,
                                      pa, "f32, contiguous, chain_steps=1",
                                      top_k=50)
    refs = dict(refs, **{"f32 step": (base32, stats32)})
    summary = []
    steps: dict = {}
    streams: dict = {}
    for label, p, c, kw, ref in (
            ("n-gram, contiguous", params, cfg, ngram, "bf16 step"),
            ("n-gram, contiguous, fused", params, cfg, dict(ngram, **fused),
             "bf16 fused"),
            ("self-draft, contiguous", params, cfg, self_bf16, "bf16 step"),
            ("self-draft, contiguous, fused", params, cfg,
             dict(self_bf16, **fused), "bf16 fused"),
            ("self-draft int8 weights, contiguous", qparams, cfg, self_int8,
             "int8 step"),
            ("self-draft int8 weights, contiguous, fused", qparams, cfg,
             dict(self_int8, **fused), "int8 fused"),
            ("n-gram, paged", params, cfg, dict(ngram, kv_layout="paged"),
             "bf16 paged"),
            ("n-gram, paged, 41 blocks", params, cfg,
             dict(ngram, kv_layout="paged", max_seq=256, kv_blocks=41),
             "bf16 paged-preempt"),
            ("self-draft f32, contiguous", f32, cfg32,
             {"draft_params": f32, "draft_cfg": cfg32}, "f32 step")):
        is_fused = "chain_steps" in kw
        paged = "kv_layout" in kw
        done, counts, stats, passes = drain(
            ServingEngine, p, c, reqs, fa, pa, f"spec {label}", top_k=50,
            draft_len=kd, **kw)
        streams[f"spec {label}"] = (done, stats)
        run, labels = stats["run"], stats["by_label"]
        rate = (run["speculative_accepted_total"]
                / max(1, run["speculative_drafts_total"]))
        if counts["flash_fwd"] <= 0:
            fail(f"spec {label}: no K1 launch")
        if paged and (counts["paged_decode"] or
                      run["kv_spec_trims_total"] <= 0):
            fail(f"spec {label}: {counts['paged_decode']} K2 launches (a "
                 f"window reads through the gather) and "
                 f"{run['kv_spec_trims_total']} spec trims")
        if "kv_blocks" in kw and run["kv_preemptions_total"] < 1:
            fail(f"spec {label}: the 41-block pool forced no preemption")
        extra = ""
        if is_fused:
            blocks = labels.get("decode_spec_fused_rows", 0)
            stray = [k for k in SPEC_STEP_LABELS + DECODE_PASSES
                     if labels.get(k)]
            if stray or blocks <= 0 or blocks != stats["replays"]:
                fail(f"spec {label}: {blocks} blocks, {stats['replays']} "
                     f"graph replays, step labels {stray}: every block "
                     f"must be one graph replay")
            replayed = passes[0] - run["graph_captures_total"]
            alive = run["speculative_drafts_total"] // kd
            extra = (f"; {stats['graph_captures_total']} graphs captured "
                     f"in {stats['graph_capture_s']:.3f} s, {blocks} blocks "
                     f"each one replay, {replayed} windows replayed, "
                     f"{8 * replayed - alive} of {8 * replayed} "
                     f"slot-windows frozen")
            pair = steps[label.removesuffix(", fused")]
            equal = same_streams(done, pair)
            if equal != len(done):
                by_uid = {f.uid: f.tokens for f in pair}
                diff = {f.uid: int(np.argmax(f.tokens != by_uid[f.uid]))
                        - f.n_prompt for f in done
                        if not np.array_equal(f.tokens, by_uid[f.uid])}
                fail(f"spec {label}: {len(done) - equal} streams differ "
                     f"from the step-by-step speculative drain's (uid: "
                     f"first differing generated token) {diff}")
            extra += (f"; {equal}/{len(done)} streams byte-equal to the "
                      f"step drain's")
        else:
            steps[label] = done
        if p is qparams:
            target = labels.get("decode_window_rows", 0) + passes[0]
            draft = stats["draft_passes"] + (kd + 1) * (
                labels.get("draft_propose_rows", 0)
                + labels.get("draft_sample_rows", 0))
            want = per_pass * (target + draft + small_fills)
            if counts["int8_matmul"] != want or counts["int8_bmm"]:
                fail(f"spec {label}: K7a launched {counts['int8_matmul']}, "
                     f"expected {per_pass} x ({target} target + {draft} "
                     f"draft passes + {small_fills} fills of <= 64 rows)")
            extra += (f"; K7a {counts['int8_matmul']} = {per_pass} x "
                      f"({target} target + {draft} draft passes + "
                      f"{small_fills} fills)")
        if "f32" in label and rate < SPEC_SELF_ACCEPT:
            fail(f"spec {label}: accept rate {rate:.4f} below "
                 f"{SPEC_SELF_ACCEPT}")
        worst = teacher_forced(p, c, done, reqs)
        base_done, base_stats = refs[ref]
        same = same_streams(done, base_done)
        row = {"label": label, "reference": ref, "accept_rate": rate,
               "windows": run["speculative_windows_total"],
               "streams_equal_to_plain": same, "streams": len(done),
               "teacher_forced_worst": worst,
               "plain": spec_row(base_stats), "spec": spec_row(stats)}
        summary.append(row)
        print(f"spec {label} ({card_line()}): accept rate {rate:.4f}, "
              f"{row['windows']} windows; tokens/s "
              f"{row['plain']['tokens_per_s']:.1f} -> "
              f"{row['spec']['tokens_per_s']:.1f}; wall ms per decode step "
              f"{row['plain']['wall_ms_per_step']:.3f} "
              f"({row['plain']['steps']} steps) -> "
              f"{row['spec']['wall_ms_per_step']:.3f} (a window); "
              f"dispatches + readbacks per token "
              f"{row['plain']['dispatch_readbacks_per_token']:.4f} -> "
              f"{row['spec']['dispatch_readbacks_per_token']:.4f}; {same}/"
              f"{len(done)} streams byte-equal to the non-speculative "
              f"engine's ({ref}); teacher-forced worst gap {worst:.4f} <= "
              f"{TF_MARGIN}" + extra, flush=True)
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    del f32, base32
    phase_spec_accept(params["embed"].device)
    for dtype in (torch.bfloat16, torch.float32):
        probe = spec_decode_probe(repeats=2, dtype=dtype,
                                  device=params["embed"].device)
        print(f"spec probe ({card_line()}): {json.dumps(probe)}", flush=True)
        if not probe["byte_equal"]:
            fail(f"spec probe in {probe['dtype']}: streams differ from the "
                 f"closed-form ramp")
    print(f"spec serving: {json.dumps(summary)}", flush=True)
    print(f"spec phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total, streams


#: the LoRA phase (``phase_lora_serving``): adapters of rank 16 from
#: ``make_adapter`` at its default scale, six of them over four resident
#: pool slots, so the drains evict and cold-load
LORA_RANK = 16
LORA_ADAPTERS = 6
LORA_RESIDENT = 4
#: each s8_r24 request's adapter: the JAX test's roster
#: (tests/test_serving_lora.py:216-217) over six adapters, twice: six
#: base rows, and the sampled requests (r3, r9, r15, r21) on adapters
LORA_ROSTER = (None, "l0", "l1", "l0", "l2", None, "l3", "l4", "l5", "l2",
               "l1", None) * 2


def lora_pool(cfg, names, n_resident: int):
    """A pool on the card holding ``names``, each adapter regenerated
    from its seed, so every pool of the phase agrees on what a name
    means."""
    from k8s_dra_driver_tpu_torch.serving_lora import (AdapterManifest,
                                                       AdapterPool,
                                                       make_adapter)
    pool = AdapterPool(cfg, LORA_RANK, n_resident)
    for name in names:
        pool.register(AdapterManifest(name, LORA_RANK, source=make_adapter(
            cfg, LORA_RANK, seed=40 + int(name[1:]))))
    return pool


def buffer_ptrs(pool) -> list:
    return [b.data_ptr() for layer in pool.buffers for b in layer]


def lora_teacher_forced(params, cfg, finished, reqs, pool) -> float:
    """Every greedy adapter stream, teacher-forced the way the engine
    decodes it: the prompt through the base model (prefill stays
    base-model; its last logits choose the first token), then one
    ``decode_window_rows`` pass over the generated tokens with the
    row's adapter.  Each generated token's logit must be within
    TF_MARGIN of its position's max.  Returns the worst gap."""
    from k8s_dra_driver_tpu_torch.models import decode as dm
    by_uid = {r.uid: r for r in reqs}
    dev = params["embed"].device
    worst = 0.0
    with torch.no_grad():
        for f in finished:
            req = by_uid[f.uid]
            if len(f.tokens) != len(req.prompt) + req.max_new:
                fail(f"{f.uid}: {len(f.tokens)} tokens, expected "
                     f"{len(req.prompt) + req.max_new}")
            if req.temperature > 0 or req.adapter is None:
                continue
            toks = torch.as_tensor(f.tokens, dtype=torch.long, device=dev)
            n = f.n_prompt
            slot = pool.acquire(req.adapter)
            cache = dm.init_cache(cfg, 1, len(f.tokens), device=dev)
            first, cache = dm.forward_with_cache(params, toks[None, :n], cfg,
                                                 cache, first_chunk=True)
            rest, _ = dm.decode_window_rows(
                params, toks[None, n:-1], cfg, cache,
                torch.tensor([n], device=dev),
                (torch.tensor([slot], device=dev), pool.buffers))
            pool.release(slot)
            pred = torch.cat([first[0, -1:], rest[0]]).float()
            if not torch.isfinite(pred).all():
                fail(f"{f.uid}: non-finite logits")
            gen = toks[n:]
            gap = pred.max(dim=-1).values - pred.gather(1, gen[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
    if worst > TF_MARGIN:
        fail(f"teacher-forced check with adapters: a greedy token's logit "
             f"is {worst:.3f} below its position's max (margin "
             f"{TF_MARGIN})")
    return worst


def lora_oracles(params, cfg, reqs, names, **kw) -> dict:
    """Each adapter's requests, and the base requests, alone on an engine
    of the drains' 8 slots whose pool holds only that adapter (so every
    product has the drain's shapes): {uid: tokens}."""
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    out = {}
    for name in [None] + names:
        pool = None if name is None else lora_pool(cfg, [name], 1)
        eng = ServingEngine(params, cfg, slots=8, top_k=50,
                            adapter_pool=pool, **kw)
        for r in reqs:
            if r.adapter == name:
                eng.submit(r)
        out.update({f.uid: f.tokens for f in eng.run()})
    return out


def phase_lora_serving(params, cfg, reqs, fa, pa, refs) -> dict:
    """Multi-adapter LoRA serving on the card: s8_r24 with LORA_ROSTER's
    adapters (rank LORA_RANK, LORA_ADAPTERS adapters over LORA_RESIDENT
    pool slots, engine top_k 50), each drain on a fresh pool beside the
    adapter-less drain of this call in ``refs`` ((finished, stats) by
    name): contiguous step by step and fused (``chain_steps`` =
    FUSED_CHAIN, the graphs reading the pool in place), paged (K2),
    ``quantize_params`` weights step by step and fused (K7a), the
    n-gram source step by step and fused, and f32 step by step.

    Gates: every pool buffer at its address after the drain (cold loads
    and evictions write in place); every base row byte-equal to the
    adapter-less drain (the null slot adds an exact zero); at least one
    adapter row apart from it; each fused drain byte-equal to its step
    drain, 24/24; K1 in every drain, K2 exactly n_layers a paged step
    call, K7a exactly 49 a pass; every fused block one graph replay and
    no capture in the measured run while it cold-loads adapters (the
    adapter-less fused drain captures none there either); greedy streams
    within TF_MARGIN teacher-forced, adapter rows through
    :func:`lora_teacher_forced`; in f32 every stream byte-equal to one-
    adapter oracle engines of the same slot count (in bf16 counted).
    Then the pool's probe at the 154M in bf16 and f32 (f32 byte-equal
    gated).  Returns the drains' summed launches."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.serving_lora.probe import (
        lora_serving_probe)
    t_phase = time.perf_counter()
    names = [f"l{i}" for i in range(LORA_ADAPTERS)]
    lreqs = [dataclasses.replace(r, adapter=a)
             for r, a in zip(reqs, LORA_ROSTER)]
    base = {r.uid for r in lreqs if r.adapter is None}
    qparams = quantize_params(params, cfg)
    f32 = map_params(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    per_pass = 6 * cfg.n_layers + 1
    ngram = {"draft_source": "ngram", "draft_len": SPEC_DRAFT_LEN}
    fused = {"chain_steps": FUSED_CHAIN}
    total: dict = {}
    summary = []
    steps: dict = {}
    for label, p, c, kw, ref, pair in (
            ("contiguous", params, cfg, {}, "bf16 step", None),
            ("contiguous, fused", params, cfg, fused, "bf16 fused",
             "contiguous"),
            ("paged", params, cfg, {"kv_layout": "paged"}, "bf16 paged",
             None),
            ("int8 weights, contiguous", qparams, cfg, {}, "int8 step",
             None),
            ("int8 weights, contiguous, fused", qparams, cfg, fused,
             "int8 fused", "int8 weights, contiguous"),
            ("n-gram, contiguous", params, cfg, ngram,
             "spec n-gram, contiguous", None),
            ("n-gram, contiguous, fused", params, cfg, dict(ngram, **fused),
             "spec n-gram, contiguous, fused", "n-gram, contiguous"),
            ("f32, contiguous", f32, cfg32, {}, None, None)):
        pool = lora_pool(c, names, LORA_RESIDENT)
        ptrs = buffer_ptrs(pool)
        done, counts, stats, passes = drain(
            ServingEngine, p, c, lreqs, fa, pa, f"lora {label}", top_k=50,
            adapter_pool=pool, **kw)
        run, labels = stats["run"], stats["by_label"]
        if buffer_ptrs(pool) != ptrs:
            fail(f"lora {label}: an adapter buffer moved")
        if counts["flash_fwd"] <= 0:
            fail(f"lora {label}: no K1 launch")
        if "kv_layout" in kw:
            calls = labels.get("paged_decode_step_rows", 0)
            if calls <= 0 or counts["paged_decode"] != cfg.n_layers * calls:
                fail(f"lora {label}: {counts['paged_decode']} K2 launches "
                     f"over {calls} paged steps, expected {cfg.n_layers} "
                     f"a step")
        if p is qparams:
            k7_passes(counts["int8_matmul"], per_pass, passes,
                      f"lora {label}")
            if counts["int8_bmm"]:
                fail(f"lora {label}: K7b launched")
        note = ""
        if c is cfg32 or label == "contiguous":
            oracle = lora_oracles(p, c, lreqs, names)
            equal = sum(np.array_equal(f.tokens, oracle[f.uid])
                        for f in done)
            if c is cfg32 and equal != len(done):
                fail(f"lora {label}: {len(done) - equal} streams differ "
                     f"from the one-adapter oracle engines'")
            note = (f"; {equal}/{len(done)} streams = one-adapter oracles "
                    f"({'gated' if c is cfg32 else 'counted'})")
        if ref is not None:
            ref_done = {f.uid: f.tokens for f in refs[ref][0]}
            same_base = sum(np.array_equal(f.tokens, ref_done[f.uid])
                            for f in done if f.uid in base)
            moved = sum(not np.array_equal(f.tokens, ref_done[f.uid])
                        for f in done if f.uid not in base)
            if same_base != len(base) or moved < 1:
                fail(f"lora {label}: {same_base}/{len(base)} base rows "
                     f"equal the adapter-less drain's ({ref}), {moved} "
                     f"adapter rows apart from it")
            note += (f"; base rows {same_base}/{len(base)} = adapter-less "
                     f"({ref}), {moved}/{len(done) - len(base)} adapter rows "
                     f"apart")
        if "chain_steps" in kw:
            tag = ("decode_spec_fused_rows" if "draft_source" in kw
                   else "decode_fused_rows")
            blocks = labels.get(tag, 0)
            stray = [k for k in SPEC_STEP_LABELS + DECODE_PASSES
                     if labels.get(k)]
            # a drain without graphs fails the replay gate just below
            ref_run = refs[ref][1]["run"].get("graph_captures_total", 0)
            if stray or blocks <= 0 or blocks != stats["replays"]:
                fail(f"lora {label}: {blocks} blocks, {stats['replays']} "
                     f"graph replays, step labels {stray}: every block "
                     f"must be one graph replay")
            captured = run.get("graph_captures_total", 0)
            if captured != ref_run or run["adapter_cold_loads_total"] <= 0:
                fail(f"lora {label}: {captured} captures in the measured "
                     f"run (adapter-less: {ref_run}) over "
                     f"{run['adapter_cold_loads_total']} cold loads")
            equal = same_streams(done, steps[pair])
            if equal != len(done):
                fail(f"lora {label}: {len(done) - equal} streams differ "
                     f"from the step drain's")
            note += (f"; {equal}/{len(done)} streams = step drain; "
                     f"{stats.get('graph_captures_total', 0)} graphs "
                     f"captured (adapter-less: "
                     f"{refs[ref][1].get('graph_captures_total', 0)}), "
                     f"{captured} in the measured run, {blocks} blocks each "
                     f"one replay")
        else:
            steps[label] = done
        tf_pool = lora_pool(c, names, LORA_ADAPTERS)
        worst = max(teacher_forced(p, c, [f for f in done if f.uid in base],
                                   lreqs),
                    lora_teacher_forced(p, c, done, lreqs, tf_pool))
        del tf_pool
        row = {"label": label, "hits": run["adapter_hits_total"],
               "cold_loads": run["adapter_cold_loads_total"],
               "evictions": run["adapter_evictions_total"],
               "tokens_per_s": stats["generated"] / stats["wall_s"],
               "wall_ms_per_step": 1e3 * stats["wall_s"]
               / max(stats["steps"], 1),
               "teacher_forced_worst": worst}
        summary.append(row)
        print(f"lora {label} ({card_line()}): pool hits {row['hits']}, cold "
              f"loads {row['cold_loads']}, evictions {row['evictions']} in "
              f"the measured run, buffers at their addresses; tokens/s "
              f"{row['tokens_per_s']:.1f}, wall ms per decode step "
              f"{row['wall_ms_per_step']:.3f}; teacher-forced worst gap "
              f"{worst:.4f} <= {TF_MARGIN}" + note, flush=True)
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    for p, c in ((params, cfg), (f32, cfg32)):
        probe = lora_serving_probe(rank=LORA_RANK, cfg=c, params=p)
        print(f"lora probe ({card_line()}): {json.dumps(probe)}", flush=True)
        if c is cfg32 and not probe["byte_equal"]:
            fail("lora probe in f32: churn streams differ from the oracle "
                 "engines'")
    print(f"lora serving: {json.dumps(summary)}", flush=True)
    print(f"lora phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


#: the tier acceptance arc at the 154M: a shared prefix of this many
#: tokens is warmed, flushed, and ridden back by a wave of TIER_WAVE
#: requests (prefix + a TIER_SUFFIX-token suffix, max_new TIER_MAX_NEW,
#: two of them sampled); the tiered engine's host arena holds
#: TIER_HOST_BYTES (a 1024-token prefix is an 8 MiB slab in bf16)
TIER_PREFIX = 1024
TIER_SUFFIX = 32
TIER_WAVE = 8
TIER_MAX_NEW = 32
TIER_HOST_BYTES = 256 << 20
#: the tier probe at the 154M: prefix, suffix and churn wave
TIER_PROBE = dict(prefix_len=1024, suffix_len=16, churn_wave=12)
#: the disaggregated and tiered drains of phase_disagg_tiers: four bf16
#: layout pairs, the f32 unified and split drains, four tier waves
DISAGG_DRAINS = 10


def kernel_snapshot(fa, pa) -> dict:
    return {"flash_fwd": fa.launches, "flash_fwd_tc": fa.tc_launches,
            "paged_decode": pa.launches}


def zero_serving_counts(fa, pa) -> None:
    fa.launches = fa.tc_launches = 0
    pa.launches = 0


def disagg_drain(params, cfg, reqs, fa, pa, label, src_kw, dst_kw):
    """Export every request on a prefill engine, then adopt the blocks in
    request order, as slots free, on a decode engine and drain it (8
    slots each, engine top_k 50); the kernel counters are zeroed before
    each side and read after it.  Fails if the decode side launched K1,
    or, on a paged decode engine, K2 other than n_layers times a decode
    step.  Returns (finished, launches of both sides)."""
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.utils import dispatch
    src = ServingEngine(params, cfg, slots=8, top_k=50, **src_kw)
    dst = ServingEngine(params, cfg, slots=8, top_k=50, **dst_kw)
    torch.cuda.synchronize()
    zero_serving_counts(fa, pa)
    t0 = time.perf_counter()
    blocks = [src.prefill_export(r) for r in reqs]
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    require_fwd_route(fa, f"{label} export", cfg.dtype == torch.bfloat16)
    exported = kernel_snapshot(fa, pa)
    zero_serving_counts(fa, pa)
    done, pending = [], list(blocks)
    t0 = time.perf_counter()
    with dispatch.track() as t:
        while pending or dst.active:
            while pending and dst.active < dst.slots:
                dst.adopt_block(pending.pop(0))
            done += dst.step()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    decoded = kernel_snapshot(fa, pa)
    steps = t.by_label.get("paged_decode_step_rows", 0)
    if decoded["flash_fwd"]:
        fail(f"{label}: the decode side launched K1 {decoded['flash_fwd']} "
             f"times")
    if dst_kw.get("kv_layout") == "paged" and (
            steps <= 0 or decoded["paged_decode"] != cfg.n_layers * steps):
        fail(f"{label}: {decoded['paged_decode']} K2 launches over {steps} "
             f"paged steps, expected {cfg.n_layers} a step")
    if len(done) != len(reqs):
        fail(f"{label}: {len(done)} of {len(reqs)} requests finished")
    gen = sum(len(f.tokens) - f.n_prompt for f in done)
    st = dst.stats()
    print(f"disagg {label} ({card_line()}): {len(blocks)} exports in "
          f"{1e3 * t_export:.1f} ms ({exported['flash_fwd']} K1 launches), "
          f"{st['kv_adoptions_total']} adoptions and {gen} tokens in "
          f"{1e3 * t_decode:.1f} ms = {gen / t_decode:.1f} tokens/s over "
          f"{st['decode_steps_total']} decode steps, {decoded['paged_decode']} "
          f"K2 launches ({steps} paged steps), no K1 on the decode side",
          flush=True)
    return done, {k: exported[k] + decoded[k] for k in exported}


def tier_wave(eng, wave, label):
    """Submit the wave to ``eng`` and drain it, dispatch labels tracked;
    returns (finished by uid, labels, wall seconds)."""
    from k8s_dra_driver_tpu_torch.utils import dispatch
    for r in wave:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dispatch.track() as t:
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(done) != len(wave):
        fail(f"tier {label}: {len(done)} of {len(wave)} requests finished")
    return {f.uid: f for f in done}, dict(t.by_label), wall


def best_ms(fn, reps: int = 5) -> float:
    """Best host wall of ``reps`` calls of ``fn``, each ended by a device
    synchronize, in ms."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def tier_costs(eng, prompt: np.ndarray, n_prefix: int) -> dict:
    """The pieces of a promotion against a recompute on a paged engine
    that holds ``prompt[:n_prefix]`` as a device entry: the demotion
    gather to the host, the slab's crc32, the promotion adopt (host to
    device into fresh blocks), the suffix fill over the promoted rows
    (dense gather + ``prefill_suffix``), and the full-prompt prefill
    that a recompute runs (K1)."""
    from k8s_dra_driver_tpu_torch.models import decode as dec
    from k8s_dra_driver_tpu_torch.models import serving as srv
    from k8s_dra_driver_tpu_torch.serving_kv import slab_checksum
    entry = eng._prefix.entry(prompt[:n_prefix])
    k, v = eng._tier_gather(entry)

    def adopt():
        eng.kv_manager.free_blocks(eng._tier_adopt(k, v))

    toks = torch.as_tensor(prompt, dtype=torch.long, device=eng.device)[None]

    def suffix():
        one = eng._kv_entry_dense(entry, n_prefix)
        srv._prefill_suffix(eng.params, toks[:, n_prefix:], eng.cfg, one)

    def prefill():
        one = dec.init_cache(eng.cfg, 1, eng.max_seq, device=eng.device)
        dec._prefill(eng.params, toks, eng.cfg, one, True)

    with torch.no_grad():
        return {"gather_ms": best_ms(lambda: eng._tier_gather(entry)),
                "crc_ms": best_ms(lambda: slab_checksum(k, v)),
                "adopt_ms": best_ms(adopt), "suffix_fill_ms": best_ms(suffix),
                "prefill_ms": best_ms(prefill),
                "slab_bytes": sum(t.numel() * t.element_size()
                                  for t in k + v)}


def phase_disagg_tiers(params, cfg, reqs, fa, pa, refs) -> dict:
    """Disaggregated prefill/decode and the KV tiers on the 154M.

    (a) s8_r24 in bf16 exported by a paged prefill engine and adopted in
    request order by a paged decode engine, then the three other layout
    pairs: no K1 on any decode side, K2 exactly n_layers a paged decode
    step, every greedy stream within TF_MARGIN teacher-forced; the
    byte-equal count against the unified paged drain of phase 8 printed.
    (b) The same split in f32 (paged into paged): every stream, sampled
    ones included, byte-equal to a unified f32 paged drain of this call.
    (c) The tier acceptance arc: a TIER_PREFIX-token prefix warmed on a
    tiered (host arena TIER_HOST_BYTES), an all-HBM and a recompute
    paged engine, flushed, then a wave of TIER_WAVE requests: the tiered
    streams byte-equal to the all-HBM engine's, with no ``prefill``
    launch and exactly one ``paged_slab_adopt``; the recompute twin's
    greedy streams within TF_MARGIN (equal count printed).  Then the
    prefix spilled to a temporary directory: a fresh engine over it
    reports it on disk and its wave is byte-equal to the all-HBM
    engine's.  The pieces of a promotion and of a recompute are timed
    alone (``tier_costs``).  (d) The tier probe at the 154M in bf16 and f32: promote
    and recompute ms printed; byte-equal gated in f32 (bf16 printed:
    its twin computes the prompt another way), the churn's hit share
    above 0 in both.  Returns the phase's K1 and K2 launches."""
    from k8s_dra_driver_tpu_torch.models.serving import (Request,
                                                         ServingEngine)
    from k8s_dra_driver_tpu_torch.serving_kv.tierprobe import (
        serving_tier_probe)
    t_phase = time.perf_counter()
    total = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    paged, contiguous = {"kv_layout": "paged"}, {}
    ref_p = refs["bf16 paged"][0]
    for src, dst in (("paged", "paged"), ("paged", "contiguous"),
                     ("contiguous", "paged"),
                     ("contiguous", "contiguous")):
        label = f"bf16 {src} -> {dst}"
        kws = [paged if x == "paged" else contiguous for x in (src, dst)]
        done, counts = disagg_drain(params, cfg, reqs, fa, pa, label, *kws)
        add(counts)
        worst = teacher_forced(params, cfg, done, reqs)
        print(f"disagg {label}: teacher-forced worst gap {worst:.4f} <= "
              f"{TF_MARGIN}; {same_streams(done, ref_p)}/{len(done)} "
              f"streams = the unified paged drain (counted)", flush=True)

    f32 = map_params(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    unified, counts, _, _ = drain(ServingEngine, f32, cfg32, reqs, fa, pa,
                                  "disagg f32 unified paged", top_k=50,
                                  kv_layout="paged")
    add(counts)
    done, counts = disagg_drain(f32, cfg32, reqs, fa, pa,
                                "f32 paged -> paged", paged, paged)
    add(counts)
    equal = same_streams(done, unified)
    if equal != len(done):
        fail(f"disagg f32: {len(done) - equal} split streams differ from "
             f"the unified drain's")
    print(f"disagg f32 paged -> paged: {equal}/{len(done)} streams = the "
          f"unified f32 paged drain (gated; sampled included)", flush=True)
    del unified

    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg.vocab, TIER_PREFIX).astype(np.int32)
    wave = [Request(uid=f"w{i}", prompt=np.concatenate(
                [prefix, rng.integers(0, cfg.vocab, TIER_SUFFIX).astype(
                    np.int32)]),
                max_new=TIER_MAX_NEW, temperature=0.8 if i in (2, 5) else 0.0,
                seed=200 + i) for i in range(TIER_WAVE)]

    def engine(**kw):
        eng = ServingEngine(params, cfg, slots=8, top_k=50, kv_layout="paged",
                            **kw)
        eng.submit(Request(uid="warm", prompt=prefix, max_new=1))
        eng.run()
        return eng

    tiered = engine(kv_host_bytes=TIER_HOST_BYTES)
    allhbm, recompute = engine(), engine()
    t0 = time.perf_counter()
    tiered._prefix.flush()
    t_demote = time.perf_counter() - t0
    arena = tiered._prefix.host_arena_bytes()
    recompute._prefix.flush()
    if tiered._prefix.demotions < 1 or arena <= 0:
        fail("tier: the flush demoted nothing to the host arena")
    zero_serving_counts(fa, pa)
    got, labels, t_tier = tier_wave(tiered, wave, "tiered")
    add(kernel_snapshot(fa, pa))
    zero_serving_counts(fa, pa)
    hbm, _, t_hbm = tier_wave(allhbm, wave, "all-HBM")
    add(kernel_snapshot(fa, pa))
    zero_serving_counts(fa, pa)
    rec, rec_labels, t_rec = tier_wave(recompute, wave, "recompute")
    add(kernel_snapshot(fa, pa))
    differ = [u for u in got if not np.array_equal(got[u].tokens,
                                                   hbm[u].tokens)]
    if differ:
        fail(f"tier: tiered streams {differ} differ from the all-HBM "
             f"engine's")
    if labels.get("prefill", 0) or labels.get("paged_slab_adopt", 0) != 1:
        fail(f"tier: the tiered wave launched {labels.get('prefill', 0)} "
             f"prefills and {labels.get('paged_slab_adopt', 0)} slab "
             f"adopts, expected 0 and 1")
    worst = teacher_forced(params, cfg, list(rec.values()), wave)
    rec_equal = sum(np.array_equal(rec[u].tokens, hbm[u].tokens)
                    for u in rec)
    st = tiered.stats()
    print(f"tier wave ({card_line()}): demotion flush {1e3 * t_demote:.2f} "
          f"ms ({TIER_PREFIX}-token slab, {arena} bytes in the host "
          f"arena); tiered wave {1e3 * t_tier:.1f} ms, all-HBM "
          f"{1e3 * t_hbm:.1f} ms, recompute {1e3 * t_rec:.1f} ms; tiered = "
          f"all-HBM {len(got)}/{len(got)} (gated); recompute twin = all-HBM "
          f"{rec_equal}/{len(rec)} (counted), its teacher-forced worst gap "
          f"{worst:.4f} <= {TF_MARGIN}; tiered labels prefill "
          f"{labels.get('prefill', 0)}, prefill_suffix "
          f"{labels.get('prefill_suffix', 0)}, paged_slab_adopt "
          f"{labels.get('paged_slab_adopt', 0)}; recompute prefill "
          f"{rec_labels.get('prefill', 0)}; tier stats "
          f"{json.dumps({k: v for k, v in st.items() if 'tier' in k})}",
          flush=True)
    costs = tier_costs(allhbm, wave[0].prompt, TIER_PREFIX)
    print(f"tier costs ({card_line()}, best of 5, host wall to a device "
          f"synchronize): {json.dumps(costs)}", flush=True)
    del tiered, recompute, rec

    with tempfile.TemporaryDirectory() as spill:
        eng = engine(kv_spill_dir=spill)
        t0 = time.perf_counter()
        eng._prefix.flush()
        t_spill = time.perf_counter() - t0
        disk_bytes = eng._prefix.disk_tier_bytes()
        del eng
        fresh = ServingEngine(params, cfg, slots=8, top_k=50,
                              kv_layout="paged", kv_spill_dir=spill)
        residency = fresh.prefix_residency(wave[0].prompt)
        if residency != (TIER_PREFIX, "disk"):
            fail(f"tier: a fresh engine over the spill directory reports "
                 f"{residency}, expected ({TIER_PREFIX}, 'disk')")
        zero_serving_counts(fa, pa)
        disk, labels, t_disk = tier_wave(fresh, wave, "from disk")
        add(kernel_snapshot(fa, pa))
        differ = [u for u in disk if not np.array_equal(disk[u].tokens,
                                                        hbm[u].tokens)]
        if differ or fresh._prefix.promotions != 1:
            fail(f"tier from disk: streams {differ} differ from the all-HBM "
                 f"engine's ({fresh._prefix.promotions} promotions)")
        print(f"tier from disk ({card_line()}): spill flush "
              f"{1e3 * t_spill:.2f} ms, {disk_bytes} bytes on disk; a fresh "
              f"engine reports {residency}, its wave {1e3 * t_disk:.1f} ms, "
              f"{len(disk)}/{len(disk)} streams = all-HBM (gated), "
              f"prefill launches {labels.get('prefill', 0)}", flush=True)
        del fresh

    for p, c in ((params, cfg), (f32, cfg32)):
        probe = serving_tier_probe(cfg=c, params=p, **TIER_PROBE)
        print(f"tier probe ({card_line()}): {json.dumps(probe)}", flush=True)
        if probe["tier_hit_frac"] <= 0:
            fail(f"tier probe {c.dtype}: no tier hit in the churn wave")
        if c is cfg32 and not probe["byte_equal"]:
            fail("tier probe in f32: the promoted streams differ from the "
                 "recompute twin's")
    print(f"disagg/tier phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


#: the fleet phase (phase_fleet): s8_r24 in FLEET_BURSTS bursts through
#: pools of 8-slot engines, each request with an SLO no run comes near
FLEET_BURSTS = 3
FLEET_SLO_S = 600.0
#: the fleet drains of phase_fleet: the f32 paged and bf16 contiguous
#: oracles, pools (a)-(d)
FLEET_DRAINS = 6
#: copies a migration cost is timed over (phase_fleet (f))
FLEET_MIGRATE_REPS = 10


def fleet_drive(gw, reqs, fa, pa, after_first=None):
    """Submit s8_r24 to ``gw`` in FLEET_BURSTS bursts, one pump step
    after each, ``after_first()`` after the first; then pump until idle.
    The kernel counters are zeroed before and read after, the dispatch
    labels tracked.  Returns (K1/K2 launches, labels, wall seconds)."""
    from k8s_dra_driver_tpu_torch.utils import dispatch
    n = len(reqs) // FLEET_BURSTS
    torch.cuda.synchronize()
    zero_serving_counts(fa, pa)
    t0 = time.perf_counter()
    with dispatch.track() as t:
        for i in range(FLEET_BURSTS):
            for r in reqs[i * n:(i + 1) * n]:
                g = gw.submit(r, slo_s=FLEET_SLO_S)
                if g.status != "queued":
                    fail(f"fleet: {r.uid} refused at the door ({g.status})")
            gw.step()
            if i == 0 and after_first is not None:
                after_first()
        gw.run_until_idle()
    torch.cuda.synchronize()
    return kernel_snapshot(fa, pa), dict(t.by_label), time.perf_counter() - t0


def fleet_exactly_once(gw, reqs, label) -> int:
    """Fail unless every uid finished exactly once and none was refused;
    returns how many outcomes survived a drain (``requeues > 0``)."""
    uids = {r.uid for r in reqs}
    statuses = {g.status for g in gw.outcomes.values()}
    if (gw.refused or set(gw.outcomes) != uids or set(gw.results) != uids
            or statuses != {"finished"}):
        fail(f"fleet {label}: {len(gw.outcomes)} outcomes ({statuses}) and "
             f"{len(gw.refused)} refusals for {len(uids)} requests")
    return sum(g.requeues > 0 for g in gw.outcomes.values())


def fleet_kernels(cfg, counts, labels, label, fills) -> int:
    """Fail unless K2 launched n_layers times a paged decode step and K1
    n_layers times a fresh prefill (``fills``: the labels of the fills
    that run K1), so none inside a decode step; returns the paged
    steps."""
    steps = labels.get("paged_decode_step_rows", 0)
    prefills = sum(labels.get(k, 0) for k in fills)
    if steps <= 0 or counts["paged_decode"] != cfg.n_layers * steps:
        fail(f"fleet {label}: {counts['paged_decode']} K2 launches over "
             f"{steps} paged decode steps, expected {cfg.n_layers} a step")
    if counts["flash_fwd"] != cfg.n_layers * prefills:
        fail(f"fleet {label}: {counts['flash_fwd']} K1 launches over "
             f"{prefills} fresh prefills, expected {cfg.n_layers} each and "
             f"none in a decode step")
    return steps


def fleet_byte_equal(gw, ref, label, gate: bool) -> int:
    """Streams of ``gw`` equal to the oracle drain ``ref``'s; fails when
    ``gate`` and any differs.  Returns the equal count."""
    by_uid = {f.uid: f.tokens for f in ref}
    equal = sum(np.array_equal(f.tokens, by_uid[u])
                for u, f in gw.results.items())
    if gate and equal != len(by_uid):
        fail(f"fleet {label}: {len(by_uid) - equal} streams differ from "
             f"the single-engine oracle's")
    return equal


def metric_value(text: str, pattern: str) -> float:
    m = re.search(pattern, text, re.M)
    if m is None:
        fail(f"fleet: no sample matches {pattern!r}")
    return float(m.group(1))


def migrate_cost(mig, entry) -> dict:
    """Mean and best ms of FLEET_MIGRATE_REPS same-card migrations of
    ``entry`` (the migrator synchronizes the card before its clock
    reads), its bytes and the mean rate."""
    walls = []
    for _ in range(FLEET_MIGRATE_REPS):
        mig.migrate_entry(entry)
        walls.append(mig.last_event[0])
    nbytes = mig.last_event[1]
    mean = sum(walls) / len(walls)
    return {"bytes": nbytes, "mean_ms": 1e3 * mean,
            "best_ms": 1e3 * min(walls), "GB_per_s": nbytes / mean / 1e9}


def phase_fleet(params, cfg, reqs, fa, pa) -> dict:
    """The fleet gateway and the two-role pool over port engines on the
    154M, s8_r24 in three bursts of 8, every replica on this card.

    (a) Unified pool in f32, paged KV (each engine's prefix store on):
    two replicas, r0 downed through the health signal after its first
    dispatch wave.  Gated: every uid finished exactly once, 1 drain, the
    requeued count equal to the outcomes with ``requeues > 0`` (at least
    1), the replacement up (1 dead, 2 ready), every stream byte-equal to
    one f32 paged engine of the same slots draining s8_r24, K2 n_layers
    a paged decode step and K1 n_layers a fresh prefill, the metric
    samples the gateway acceptance reads.  (b) The same in bf16 on
    contiguous KV: exactly once, every greedy stream within TF_MARGIN
    teacher-forced; the byte-equal count against one bf16 contiguous
    engine printed.  (c) Two-role pool in f32: one paged prefill replica
    and two paged decode replicas behind ``DisaggRouter``,
    ``auto_replace=False``: exactly once, byte-equal to (a)'s oracle,
    24 migrations and ``tpu_gateway_kv_migrations_total`` 24, no
    ``prefill*`` label on a decode replica and no ``decode_*`` on the
    prefill replica, every request finished on a decode replica.  (d)
    The prefill replica downed after its first export wave: exactly
    once, the decode replicas prefill locally, byte-equal.  (e) The
    probes in bf16 at the 154M: ``gateway_probe`` (goodput, SLO
    attainment, queue waits; its accounting gated) and
    ``disagg_probe`` (TTFT unified against split, migration ms and
    bytes; its byte-equality printed: the unified pool's padded fill
    groups and the split pool's [1, L] exports round apart in bf16),
    then ``disagg_probe`` in f32 with its byte-equality gated.  (f)
    Same-card migration costs of
    a bf16 [1, 2048] cache and a bf16 96-token paged slab.  Returns the
    phase's K1 and K2 launches."""
    from k8s_dra_driver_tpu_torch.gateway import (FleetGateway,
                                                  ReplicaManager,
                                                  gateway_probe)
    from k8s_dra_driver_tpu_torch.gateway.replica import ROLE_DECODE
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.serving_disagg import (
        DisaggReplicaManager, DisaggRouter, KVMigrator, disagg_probe)
    t_phase = time.perf_counter()
    total = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    f32 = map_params(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    def f32_paged(name=None):
        return ServingEngine(f32, cfg32, slots=8, top_k=50,
                             kv_layout="paged")

    def bf16_contiguous(name=None):
        return ServingEngine(params, cfg, slots=8, top_k=50, prefix_cache=4)

    oracle32, counts, _, _ = drain(ServingEngine, f32, cfg32, reqs, fa, pa,
                                   "fleet oracle f32 paged", top_k=50,
                                   kv_layout="paged")
    add(counts)
    oracle16, counts, _, _ = drain(ServingEngine, params, cfg, reqs, fa, pa,
                                   "fleet oracle bf16 contiguous", top_k=50,
                                   prefix_cache=4)
    add(counts)

    # (a) and (b): unified pools, r0 downed after its first wave
    for label, factory, dtype_cfg in (("(a) f32 paged", f32_paged, cfg32),
                                      ("(b) bf16 contiguous",
                                       bf16_contiguous, cfg)):
        unhealthy: dict = {}
        mgr = ReplicaManager(factory, replicas=2,
                             health_source=lambda u=unhealthy: u,
                             chip_of=lambda name: name)
        gw = FleetGateway(mgr, queue_capacity=64)
        counts, labels, wall = fleet_drive(
            gw, reqs, fa, pa,
            after_first=lambda u=unhealthy: u.update(
                r0="downed by the health signal"))
        add(counts)
        require_fwd_route(fa, f"fleet {label}",
                          dtype_cfg.dtype == torch.bfloat16)
        requeued = fleet_exactly_once(gw, reqs, label)
        st = gw.stats()
        if st["replicas"]["dead"] != 1 or st["replicas"]["ready"] != 2:
            fail(f"fleet {label}: replicas {st['replicas']}, expected 1 "
                 f"dead and 2 ready")
        text = gw.metrics.render().decode()
        drains = metric_value(text, r"^tpu_gateway_drains_total (\S+)$")
        n_requeued = metric_value(text,
                                  r"^tpu_gateway_requeued_total (\S+)$")
        waits = metric_value(
            text, r"^tpu_gateway_queue_wait_seconds_count (\S+)$")
        ttfts = metric_value(text, r"^tpu_gateway_ttft_seconds_count (\S+)$")
        if (drains != 1 or requeued < 1 or n_requeued != requeued
                or waits != len(reqs) + requeued or ttfts != len(reqs)):
            fail(f"fleet {label}: drains {drains}, requeued {n_requeued} "
                 f"(outcomes {requeued}), queue waits {waits}, TTFTs "
                 f"{ttfts} for {len(reqs)} requests")
        gen = sum(len(f.tokens) - f.n_prompt for f in gw.results.values())
        if dtype_cfg is cfg32:
            steps = fleet_kernels(cfg, counts, labels, label, ("prefill",))
            equal = fleet_byte_equal(gw, oracle32, label, gate=True)
            check = (f"{equal}/{len(reqs)} streams = the f32 paged oracle "
                     f"(gated); K2 {counts['paged_decode']} = "
                     f"{cfg.n_layers} x {steps} paged steps, K1 "
                     f"{counts['flash_fwd']} = {cfg.n_layers} x "
                     f"{labels.get('prefill', 0)} prefills (gated)")
        else:
            worst = teacher_forced(params, cfg, list(gw.results.values()),
                                   reqs)
            equal = fleet_byte_equal(gw, oracle16, label, gate=False)
            check = (f"teacher-forced worst gap {worst:.4f} <= {TF_MARGIN} "
                     f"(gated); {equal}/{len(reqs)} streams = the bf16 "
                     f"contiguous oracle (counted); K1 {counts['flash_fwd']}")
        print(f"fleet {label} ({card_line()}): exactly once {len(reqs)}/"
              f"{len(reqs)}, 1 drain, {requeued} requeued, replicas "
              f"{st['replicas']['ready']} ready + {st['replicas']['dead']} "
              f"dead; {gen} tokens in {1e3 * wall:.1f} ms = "
              f"{gen / wall:.1f} tokens/s over {st['steps']} pump steps; "
              f"{check}", flush=True)
        del gw, mgr

    # (c) and (d): the two-role pool, f32 paged, then its prefill kill
    for label, kill in (("(c) two-role f32", False),
                        ("(d) prefill downed f32", True)):
        unhealthy = {}
        mgr = DisaggReplicaManager(f32_paged, prefill_replicas=1,
                                   decode_replicas=2, depth_bound=8,
                                   health_source=lambda u=unhealthy: u,
                                   chip_of=lambda name: name)
        gw = FleetGateway(mgr, router=DisaggRouter(mgr.index),
                          queue_capacity=64, auto_replace=False)
        counts, labels, wall = fleet_drive(
            gw, reqs, fa, pa,
            after_first=(lambda u=unhealthy: u.update(
                p0="downed by the health signal")) if kill else None)
        add(counts)
        require_fwd_route(fa, f"fleet {label}", False)
        requeued = fleet_exactly_once(gw, reqs, label)
        steps = fleet_kernels(cfg, counts, labels, label, ("prefill",))
        equal = fleet_byte_equal(gw, oracle32, label, gate=True)
        per = gw.stats()["per_replica_dispatches"]
        by_role = {r.name: r.role for r in mgr.replicas}
        decode = {n for n, role in by_role.items() if role == ROLE_DECODE}
        local = 0
        for name, role in by_role.items():
            lbls = per.get(name, {}).get("by_label", {})
            bad = "prefill" if role == ROLE_DECODE else "decode_"
            hits = [k for k in lbls if k.startswith(bad)]
            if role == ROLE_DECODE:
                local += sum(lbls[k] for k in hits)
            if hits and not (kill and role == ROLE_DECODE):
                fail(f"fleet {label}: replica {name} ({role}) launched "
                     f"{hits}")
        if {g.replica for g in gw.outcomes.values()} - decode:
            fail(f"fleet {label}: a request finished off the decode "
                 f"replicas")
        mig = mgr.migration_stats()
        text = gw.metrics.render().decode()
        migrations = metric_value(
            text, r"^tpu_gateway_kv_migrations_total (\S+)$")
        if kill:
            drains = metric_value(text, r"^tpu_gateway_drains_total (\S+)$")
            if drains != 1 or requeued < 1 or local <= 0:
                fail(f"fleet {label}: drains {drains}, requeued {requeued}, "
                     f"decode-side prefills {local}")
        elif mig["migrations"] != len(reqs) or migrations != len(reqs):
            fail(f"fleet {label}: {mig['migrations']} migrations "
                 f"({migrations} in the metrics), expected {len(reqs)}")
        gen = sum(len(f.tokens) - f.n_prompt for f in gw.results.values())
        mean_ms = (1e3 * mig["wall_s"] / mig["migrations"]
                   if mig["migrations"] else 0.0)
        print(f"fleet {label} ({card_line()}): exactly once {len(reqs)}/"
              f"{len(reqs)}, {equal}/{len(reqs)} streams = the f32 paged "
              f"oracle (gated), {requeued} requeued, decode-side prefills "
              f"{local}; {mig['migrations']} migrations of "
              f"{mig['bytes_moved']} bytes ({mean_ms:.3f} ms mean, "
              f"{mig['tokens_moved']} tokens); K2 {counts['paged_decode']} "
              f"= {cfg.n_layers} x {steps} paged steps, K1 "
              f"{counts['flash_fwd']}; {gen} tokens in {1e3 * wall:.1f} ms "
              f"= {gen / wall:.1f} tokens/s; role split held", flush=True)
        del gw, mgr

    # (e) the probes at the 154M in bf16, with their JAX traffic defaults
    probe = gateway_probe(cfg=cfg, params=params)
    print(f"fleet gateway probe ({card_line()}): {json.dumps(probe)}",
          flush=True)
    if not probe["valid"]:
        fail("fleet gateway probe: a request went unaccounted")
    # the unified pool fills padded groups, the split pool [1, L]
    # exports: bf16 products of other row counts round apart, so the
    # probe's byte-equality is printed in bf16 and gated in f32
    for p, c in ((params, cfg), (f32, cfg32)):
        probe = disagg_probe(cfg=c, params=p)
        print(f"fleet disagg probe {str(c.dtype)[6:]} ({card_line()}): "
              f"{json.dumps(probe)}", flush=True)
        if c is cfg32 and not probe["byte_equal"]:
            fail("fleet disagg probe in f32: split streams differ from "
                 "the unified pool's")

    # (f) same-card migration costs in bf16: a [1, 2048] cache, a slab
    mig = KVMigrator()
    prompt96 = reqs[0].prompt
    costs = {}
    for name, kw in (("[1, 2048] cache", {}),
                     ("96-token paged slab", {"kv_layout": "paged"})):
        eng = ServingEngine(params, cfg, slots=8, top_k=50, **kw)
        blk = eng.prefill_export(type(reqs[0])(uid="m", prompt=prompt96,
                                               max_new=1))
        costs[name] = migrate_cost(mig, blk.kv)
        del eng, blk
    print(f"fleet migrate ({card_line()}, {FLEET_MIGRATE_REPS} same-card "
          f"copies into fresh storage each): {json.dumps(costs)}",
          flush=True)
    print(f"fleet phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


#: the process fleet (phase_procfleet): pump processes of the 154M in f32
PROC_WORKERS = 3
#: s8_r24 requests whose KV blocks cross between two pump processes
#: (r3 is sampled)
PROC_HANDOFFS = 4
#: the bf16 block the conductor round-trips through the codec: a
#: [1, PROC_CODEC_SEQ] cache
PROC_CODEC_SEQ = 1024
#: pump widths of the multi-process scaling probe
PROC_PROBE_WIDTHS = (1, 2, 4)


def proc_engine_cfg(cfg) -> dict:
    """The pumps' ``--engine-cfg``: the 154M's fields, in float32."""
    return {f: getattr(cfg, f) for f in (
        "vocab", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_head",
        "d_ff", "max_seq")} | {"dtype": "float32"}


def proc_kernel_counts(gw, cfg, label: str, gate: bool) -> dict:
    """Every live pump's K1/K2 counters (``op_stats``); with ``gate``,
    fail unless each pump launched K1 a positive multiple of n_layers
    times, none on the tensor-core route (f32) and no K2 (contiguous).
    Returns the counters summed."""
    total = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}
    for h in gw.handles:
        if not h.live:
            continue
        k = gw._rpc(h, "stats")["kernel_launches"]
        if gate and (k["flash_fwd"] <= 0 or k["flash_fwd"] % cfg.n_layers
                     or k["flash_fwd_tc"] or k["paged_decode"]):
            fail(f"procfleet {label}: pump {h.name} reported {k}, expected "
                 f"K1 a positive multiple of {cfg.n_layers}, all on the "
                 f"f32 route, and no K2")
        for n in total:
            total[n] += k[n]
    return total


def phase_procfleet(params, cfg, reqs, fa, pa) -> dict:
    """The multi-process gateway on the card: pump processes, each with
    its own CUDA context and its own 154M replica, behind the conductor
    ``ProcessGateway``; s8_r24 in FLEET_BURSTS bursts.

    (a) f32 pool through a kill: PROC_WORKERS pumps of one 8-slot f32
    contiguous replica each (``tiny_model`` of the 154M's fields in
    float32), the pump holding r0 SIGKILLed by the fault plan at the
    cycle after the first burst's dispatch.  Gated: every uid finished
    exactly once and none refused; the journal's replay without
    conflicts or corrupt records; one pump death and at least one
    outcome requeued; every stream byte-equal to one f32 contiguous
    engine of 8 slots in this process, built by the same ``tiny_model``
    and draining s8_r24; each survivor's K1 launches a positive multiple
    of n_layers, on the f32 route.  (b) The KV handoff across two
    surviving pumps: PROC_HANDOFFS requests (one sampled) exported on one
    (``kv_export``: prefill, then the wire codec) and adopted on the
    other (``kv_adopt``); gated: the adopted streams equal (a)'s oracle;
    printed: frame bytes and the export, encode, pipe, decode, adopt and
    generation ms.  (c) The bf16 codec in this process: a bf16 [1,
    PROC_CODEC_SEQ] block of the 154M (``prefill_export``) through
    ``encode_kv_block``, ``json.dumps`` / ``loads`` and
    ``decode_kv_block``; gated: every leaf bit-equal, the adopted copy's
    tokens equal to the exported block's own; printed: frame MB, the
    encode, dumps, loads and decode ms beside a same-card copy of the
    same block (``KVMigrator``).  (d) ``multiproc_probe`` with null
    engines at PROC_PROBE_WIDTHS pumps (each pump opens the card):
    ``scaling_x``, the host's CPUs, wall admissions/s; not gated.
    Returns the K1/K2 launches: this process's (the oracle drain and
    (c)) plus the surviving pumps' (a SIGKILLed pump's are lost)."""
    from k8s_dra_driver_tpu_torch.cluster.faults import (PUMP_KIND,
                                                         PUMP_VERB,
                                                         FaultPlan,
                                                         FaultRule)
    from k8s_dra_driver_tpu_torch.gateway.procprobe import multiproc_probe
    from k8s_dra_driver_tpu_torch.gateway.procpump import (ProcessGateway,
                                                           tiny_model)
    from k8s_dra_driver_tpu_torch.gateway.wire import encode_request
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.serving_disagg import KVMigrator
    from k8s_dra_driver_tpu_torch.serving_disagg.wirekv import (
        decode_kv_block, encode_kv_block, frame_bytes)
    t_phase = time.perf_counter()
    total = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    engine_cfg = proc_engine_cfg(cfg)
    cfg32, params32 = tiny_model(engine_cfg, "cuda")
    oracle, counts, _, _ = drain(ServingEngine, params32, cfg32, reqs, fa,
                                 pa, "procfleet oracle f32 contiguous")
    add(counts)
    by_uid = {f.uid: f.tokens for f in oracle}
    del oracle, params32

    # (a) the pool, one pump SIGKILLed after the first burst's dispatch
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        gw = ProcessGateway(td, workers=PROC_WORKERS, engine="tiny",
                            engine_cfg=engine_cfg, replicas=1, slots=8,
                            pump_plan=FaultPlan(), device="cuda")
        t_up = time.perf_counter() - t0
        try:
            victim = f"pump{gw._shard(reqs[0].prompt)}"
            # membership is checked at the start of each cycle: the
            # first passes (the burst dispatches), the second kills
            gw.pump_plan.arm(FaultRule(verb=PUMP_VERB, kind=PUMP_KIND,
                                       name=victim, skip=1, times=1,
                                       error="crash"))
            n = len(reqs) // FLEET_BURSTS
            t0 = time.perf_counter()
            for i in range(FLEET_BURSTS):
                for r in reqs[i * n:(i + 1) * n]:
                    g = gw.submit(r, slo_s=FLEET_SLO_S)
                    if g.status != "queued":
                        fail(f"procfleet (a): {r.uid} refused at the door "
                             f"({g.status})")
                gw.step()
            gw.run_until_idle()
            wall = time.perf_counter() - t0
            uids = {r.uid for r in reqs}
            statuses = {g.status for g in gw.outcomes.values()}
            if (gw.refused or set(gw.outcomes) != uids
                    or set(gw.results) != uids or statuses != {"finished"}):
                fail(f"procfleet (a): {len(gw.outcomes)} outcomes "
                     f"({statuses}), {len(gw.refused)} refusals for "
                     f"{len(uids)} requests")
            view = gw.store.replay()
            st = gw.stats()
            requeued = sum(g.requeues > 0 for g in gw.outcomes.values())
            if view.conflicts or view.corrupt or set(view.terminals) != uids:
                fail(f"procfleet (a): journal replay holds "
                     f"{len(view.terminals)} terminals, conflicts "
                     f"{view.conflicts}, corrupt {view.corrupt}")
            if st["pump_deaths"] != 1 or requeued < 1:
                fail(f"procfleet (a): {st['pump_deaths']} pump deaths, "
                     f"{requeued} requeued outcomes")
            equal = sum(np.array_equal(f.tokens, by_uid[u])
                        for u, f in gw.results.items())
            if equal != len(reqs):
                fail(f"procfleet (a): {len(reqs) - equal} streams differ "
                     f"from the single-engine oracle's")
            k_a = proc_kernel_counts(gw, cfg, "(a)", gate=True)
            gen = sum(len(f.tokens) - f.n_prompt
                      for f in gw.results.values())
            print(f"procfleet (a) f32 ({card_line()}): {PROC_WORKERS} pumps "
                  f"up in {t_up:.1f} s; {victim} SIGKILLed after the first "
                  f"burst; exactly once {len(reqs)}/{len(reqs)}, journal "
                  f"{len(view.terminals)} terminals (conflicts 0, corrupt "
                  f"0, torn {view.torn}, duplicates {view.duplicates}), "
                  f"{requeued} requeued, adopted from the journal "
                  f"{st['adopted_from_journal']}, steals {st['steals']}; "
                  f"{equal}/{len(reqs)} streams = the f32 oracle (gated); "
                  f"{gen} tokens in {1e3 * wall:.1f} ms = "
                  f"{gen / wall:.1f} tokens/s over {st['steps']} conductor "
                  f"cycles; survivors' K1 {k_a['flash_fwd']} (each a "
                  f"multiple of {cfg.n_layers}, f32 route)", flush=True)

            # (b) the handoff: export on one survivor, adopt on the other
            src, dst = [h for h in gw.handles if h.live]
            for r in reqs[:PROC_HANDOFFS]:
                t0 = time.perf_counter()
                exp = gw._rpc(src, "kv_export", req=encode_request(r))
                t1 = time.perf_counter()
                got = gw._rpc(dst, "kv_adopt", block=exp["block"])
                t2 = time.perf_counter()
                if not np.array_equal(np.asarray(got["tokens"], np.int32),
                                      by_uid[r.uid]):
                    fail(f"procfleet (b): {r.uid} adopted across pumps "
                         f"differs from the oracle's stream")
                ms_e, ms_a = exp["ms"], got["ms"]
                pipe_out = 1e3 * (t1 - t0) - ms_e["export"] - ms_e["encode"]
                pipe_in = (1e3 * (t2 - t1) - ms_a["decode"] - ms_a["adopt"]
                           - ms_a["generate"])
                print(f"procfleet (b) {r.uid} "
                      f"({'sampled' if r.temperature > 0 else 'greedy'}, "
                      f"{card_line()}): {src.name} -> {dst.name}, frame "
                      f"{frame_bytes(exp['block'])} bytes; export "
                      f"{ms_e['export']:.2f} ms, encode {ms_e['encode']:.2f}, "
                      f"pipe out {pipe_out:.2f}, pipe in {pipe_in:.2f}, "
                      f"decode onto the card {ms_a['decode']:.2f}, adopt "
                      f"{ms_a['adopt']:.2f}, generate {ms_a['generate']:.2f}; "
                      f"stream = the oracle's (gated)", flush=True)
            add(proc_kernel_counts(gw, cfg, "(b)", gate=False))
        finally:
            gw.close()

    # (c) the bf16 codec in this process: encode, JSON, decode
    eng = ServingEngine(params, cfg, slots=8, max_seq=PROC_CODEC_SEQ)
    req = type(reqs[0])(uid="codec", prompt=reqs[0].prompt, max_new=48)
    torch.cuda.synchronize()
    zero_serving_counts(fa, pa)
    blk = eng.prefill_export(req)
    torch.cuda.synchronize()
    add(kernel_snapshot(fa, pa))
    require_fwd_route(fa, "procfleet (c) export", True)
    t0 = time.perf_counter()
    enc = encode_kv_block(blk)
    t1 = time.perf_counter()
    text = json.dumps(enc)
    t2 = time.perf_counter()
    back = json.loads(text)
    t3 = time.perf_counter()
    got = decode_kv_block(back, dest="cuda")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    leaves = list(zip(got.kv.tensors(), blk.kv.tensors()))
    if not all(a.dtype == b.dtype == torch.bfloat16
               and a.device == b.device and a.data_ptr() != b.data_ptr()
               and torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in leaves):
        fail("procfleet (c): a decoded bf16 leaf differs from the "
             "exported one (or shares its storage)")
    toks = []
    for b in (blk, got):
        eng.adopt_block(b)
        toks.append(eng.run()[0].tokens)
    if not np.array_equal(toks[0], toks[1]):
        fail("procfleet (c): the decoded block's stream differs from the "
             "exported block's")
    copy = migrate_cost(KVMigrator(), blk.kv)
    print(f"procfleet (c) bf16 codec ({card_line()}): [1, "
          f"{PROC_CODEC_SEQ}] block, {len(leaves)} leaves bit-equal, "
          f"stream equal (gated); frame {len(text) / 1e6:.3f} MB "
          f"({frame_bytes(enc)} payload bytes, {copy['bytes']} raw); "
          f"encode {1e3 * (t1 - t0):.2f} ms, json.dumps "
          f"{1e3 * (t2 - t1):.2f}, json.loads {1e3 * (t3 - t2):.2f}, "
          f"decode onto the card {1e3 * (t4 - t3):.2f}; a same-card copy "
          f"of the same block {copy['mean_ms']:.3f} ms (best "
          f"{copy['best_ms']:.3f})", flush=True)
    del eng, blk, got, enc, back, text

    # (d) the scaling probe, null engines, every pump on the card
    probe = multiproc_probe(pump_counts=PROC_PROBE_WIDTHS, device="cuda")
    walls = {lv["pumps"]: lv["admissions_per_wall_s"]
             for lv in probe["levels"]}
    print(f"procfleet (d) multiproc probe ({card_line()}): scaling_x "
          f"{probe['scaling_x']} (CPU-time-normalized, widths "
          f"{probe['pump_counts']}), host_cpus {probe['host_cpus']}, "
          f"wall admissions/s by width {walls}, outcome counts equal "
          f"{probe['outcome_counts_equal']}, fsync p50 "
          f"{probe['outcome_fsync_ms']} ms (not gated)", flush=True)
    print(f"procfleet phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


#: the observatory probe's request counts (bench.py TINY_OBS_KWARGS)
OBS_PROBE_KWARGS = dict(n_requests=96, reps=2, pumps=2, replicas=2, slots=4,
                        queue_capacity=48)
#: allowed gap between the allocator's rise over an engine build and the
#: MemWatch ledger of that engine (phase_observability (a))
LEDGER_TOL = 0.05
#: the control loop's pump-step clock: fake seconds a cycle
CTL_DT = 0.5
#: the burst's deadline in fake seconds: every request is dispatched
#: within it (three replicas of 8 slots take s8_r24 in three cycles),
#: none can finish within it (48 tokens take 48 cycles)
CTL_TIGHT_SLO_S = 10.0
#: the cycles one control-loop scenario may take before it fails
CTL_MAX_CYCLES = 400
#: rank and resident slots of the low tenant's adapter pools
#: (phase_fleet_control (b))
MT_RANK = 16
MT_ADAPTERS = 3


def allocated() -> int:
    """Live tensor bytes of the card's caching allocator, after a
    synchronize."""
    torch.cuda.synchronize()
    return int(torch.cuda.memory_stats()["allocated_bytes.all.current"])


def param_tensors(params) -> list:
    return [params["embed"], params["unembed"], params["ln_f"]] + [
        t for layer in params["layers"] for t in layer.values()]


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


#: the dispatch labels of the fills that run K1: a fresh paged fill
#: (``prefill``) and a contiguous engine's padded fresh group
#: (``prefill_adopt_rows``); suffix fills over cached rows read the
#: cache without K1
K1_FILLS = ("prefill", "prefill_adopt_rows")


def kv_kernel_counts(cfg, counts, labels, label) -> str:
    """``fleet_kernels`` over K1_FILLS; returns the line that says what
    it held."""
    steps = fleet_kernels(cfg, counts, labels, label, K1_FILLS)
    fills = sum(labels.get(k, 0) for k in K1_FILLS)
    return (f"K2 {counts['paged_decode']} = {cfg.n_layers} x {steps} paged "
            f"steps, K1 {counts['flash_fwd']} = {cfg.n_layers} x {fills} "
            f"fresh fills (gated)")


def phase_observability(cfg, reqs, fa, pa) -> dict:
    """Serving observability on the card at the 154M, params made here
    from generator seed 0.

    (a) Memory ledger: the allocator's live bytes
    (``allocated_bytes.all.current``) read before and after building a
    bf16 paged engine of 8 slots, then ``MemWatch().account_engine``.
    Gated: ``model_params`` + ``paged_kv_pool`` equal a ``numel x
    element_size`` sum over the engine's parameter and pool tensors,
    exactly; the allocator's rise within LEDGER_TOL of the ledger total
    (both printed, and the ratio); the source ``"device"``.  Then s8_r24
    drained through that engine: every stream within TF_MARGIN
    teacher-forced, K2 n_layers a paged step and K1 n_layers a fresh
    prefill, the ledger unchanged; what the allocator holds beyond the
    ledger after the drain printed, with the engine's device mirrors
    named.  (b) ``observatory_probe`` at bench.py's TINY_OBS_KWARGS
    request counts with the 154M in bf16 as its accounted engine: gated
    ``valid``, source ``"device"``, the merged digest count equal to the
    per-pump counts' sum; printed ``digest_overhead_x``.  (c)
    ``paged_kv_probe`` at the 154M in f32 (gated: ``byte_equal``, CoW
    share above 0, no allocation failure, paged concurrency above
    contiguous; K2 n_layers a paged step and K1 n_layers a fresh prefill)
    and in bf16 (printed).  Returns the phase's K1 and K2 launches."""
    from k8s_dra_driver_tpu_torch.gateway.obsprobe import observatory_probe
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    from k8s_dra_driver_tpu_torch.serving_kv import probe as kv_probe
    from k8s_dra_driver_tpu_torch.utils import dispatch
    from k8s_dra_driver_tpu_torch.utils.memwatch import MemWatch, tree_nbytes
    t_phase = time.perf_counter()
    total = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    # (a) the ledger against the allocator: freed blocks cached by
    # earlier phases are returned first, so the build's tensors get
    # blocks of their own (512-byte rounding) instead of reusing larger
    # cached ones whole
    gc.collect()
    torch.cuda.empty_cache()
    # K2's split-merge workspace and arrival counters, kept per stream
    # and grown on demand: what the drain adds there is no engine's
    k2_before = sum(nbytes(pair) for pair in pa._buffers.values())
    before = allocated()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    eng = ServingEngine(params, cfg, slots=8, top_k=50, kv_layout="paged")
    after = allocated()
    mw = MemWatch()
    mw.account_engine(eng, "r0")
    snap = mw.snapshot()
    comps = dict(snap["components"])
    want = {"model_params/r0": nbytes(param_tensors(params)),
            "paged_kv_pool/r0": nbytes(eng.pool.tensors())}
    if comps != want:
        fail(f"obs (a): ledger {comps} != the tensors' bytes {want}")
    if snap["device_source"] != "device":
        fail(f"obs (a): MemWatch read its {snap['device_source']!r}, not "
             f"the card's allocator")
    ledger = snap["accounted_bytes"]
    rise = after - before
    ratio = rise / ledger
    if abs(ratio - 1.0) > LEDGER_TOL:
        fail(f"obs (a): the allocator rose {rise} bytes over the engine "
             f"build, the ledger holds {ledger} (ratio {ratio:.6f}, "
             f"allowed 1 +- {LEDGER_TOL})")
    print(f"obs (a) memory ledger ({card_line()}): 154M bf16 paged engine, "
          f"model_params {want['model_params/r0']} + paged_kv_pool "
          f"{want['paged_kv_pool/r0']} = {ledger} bytes (= numel x "
          f"element_size, gated); allocator rise {rise} bytes, ratio "
          f"{ratio:.6f} (uncapped; within {LEDGER_TOL}, gated); "
          f"accounted_frac of the whole allocator "
          f"{snap['accounted_frac']:.4f} over "
          f"{snap['device_bytes_in_use']} bytes (source "
          f"{snap['device_source']})", flush=True)
    for r in reqs:
        eng.submit(r)
    zero_serving_counts(fa, pa)
    t0 = time.perf_counter()
    with dispatch.track() as t:
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_snapshot(fa, pa)
    add(counts)
    require_fwd_route(fa, "obs (a)", True)
    if len(done) != len(reqs):
        fail(f"obs (a): {len(done)} of {len(reqs)} requests finished")
    worst = teacher_forced(params, cfg, done, reqs)
    check = kv_kernel_counts(cfg, counts, t.by_label, "obs (a)")
    again = MemWatch()
    again.account_engine(eng, "r0")
    if again.snapshot()["components"] != comps:
        fail(f"obs (a): the ledger moved over the drain: "
             f"{again.snapshot()['components']} != {comps}")
    held = allocated() - before
    mirrors = {name: tree_nbytes(getattr(eng, name, None))
               for name in ("_table_dev", "_kv_dense_memo", "_lora_dev")}
    k2_grown = sum(nbytes(pair) for pair in pa._buffers.values()) - k2_before
    print(f"obs (a) after draining s8_r24 ({wall:.3f} s): ledger unchanged "
          f"(gated); teacher-forced worst gap {worst:.4f} <= {TF_MARGIN} "
          f"(gated); {check}; the allocator holds {held} bytes over the "
          f"pre-build reading, {held - ledger} beyond the ledger: K2's "
          f"workspace and counters grew {k2_grown}, the engine's device "
          f"mirrors {mirrors}, the rest "
          f"{held - ledger - k2_grown - sum(mirrors.values())} (no engine "
          f"tensor: a matrix library's workspace made at this process's "
          f"first product and the like)", flush=True)
    del eng, params, done, mw, again

    # (b) the observatory probe
    probe = observatory_probe(**OBS_PROBE_KWARGS, cfg=cfg, device="cuda")
    if not probe["valid"]:
        fail(f"obs (b): observatory_probe not valid: {probe}")
    if probe["hbm_device_source"] != "device":
        fail(f"obs (b): the probe's ledger read {probe['hbm_device_source']}")
    if probe["merged_digest_count"] != sum(probe["per_pump_counts"]):
        fail(f"obs (b): merged count {probe['merged_digest_count']} != the "
             f"per-pump counts {probe['per_pump_counts']}")
    print(f"obs (b) observatory probe ({card_line()}): valid (gated), "
          f"digest_overhead_x {probe['digest_overhead_x']} (ratios "
          f"{probe['digest_ratios']}), merged count "
          f"{probe['merged_digest_count']} = sum of per-pump "
          f"{probe['per_pump_counts']} (gated), merged quantiles "
          f"{probe['merged_quantiles']}; the 154M engine's ledger "
          f"{probe['hbm_accounted_bytes']} bytes, accounted_frac "
          f"{probe['hbm_accounted_frac']} of {probe['hbm_device_bytes']} "
          f"allocated (source {probe['hbm_device_source']}, gated), "
          f"components {probe['hbm_components']}", flush=True)

    # (c) the paged-KV probe, f32 (gated) then bf16 (printed)
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        pcfg = dataclasses.replace(cfg, dtype=dtype)
        zero_serving_counts(fa, pa)
        # the concurrency wave's two drains (paged, then contiguous) are
        # the probe's first two pumps: keep them to count equal streams
        waves, pump = [], kv_probe._pump
        kv_probe._pump = lambda eng: waves.append(pump(eng)) or waves[-1]
        try:
            with dispatch.track() as t:
                out = kv_probe.paged_kv_probe(cfg=pcfg, device="cuda")
        finally:
            kv_probe._pump = pump
        torch.cuda.synchronize()
        paged_done, contig_done = waves[0][0], waves[1][0]
        equal = sum(np.array_equal(f.tokens, contig_done[u].tokens)
                    for u, f in paged_done.items())
        counts = kernel_snapshot(fa, pa)
        add(counts)
        require_fwd_route(fa, f"obs (c) {name}", dtype == torch.bfloat16)
        line = (f"obs (c) paged-KV probe {name} ({card_line()}): "
                f"pg_max_concurrent_x {out['pg_max_concurrent_x']} (paged "
                f"{out['paged_peak_active']} / contiguous "
                f"{out['contig_peak_active']} over {out['budget_rows']} "
                f"rows), pg_cow_shared_frac {out['pg_cow_shared_frac']}, "
                f"alloc_failures {out['alloc_failures']}, byte_equal "
                f"{out['byte_equal']} ({equal}/{len(paged_done)} wave "
                f"streams equal), pg_decode_tok_s_ratio "
                f"{out['pg_decode_tok_s_ratio']} (paged "
                f"{out['paged_tok_s']} / contiguous {out['contig_tok_s']} "
                f"tokens/s), wall {out['wall_s']} s")
        if dtype == torch.float32:
            if not (out["byte_equal"] and out["pg_cow_shared_frac"] > 0
                    and out["alloc_failures"] == 0
                    and out["pg_max_concurrent_x"] > 1):
                fail(f"obs (c): f32 probe gates failed: {out}")
            line += "; gates held; " + kv_kernel_counts(
                cfg, counts, t.by_label, "obs (c) f32")
        else:
            line += f" (not gated); K1 {counts['flash_fwd']}, K2 " \
                    f"{counts['paged_decode']}"
        print(line, flush=True)
    print(f"obs phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def control_loop(make_engine, waves, slo_s, fault=True):
    """The 1x1 fleet loop: ``FleetReconciler`` over a ``FleetGateway``
    of one replica at start (``auto_replace=False``), ``ChipLedger([0, 1,
    2, 3])`` as allocation labels (every replica lives on this card),
    ``health_source = ledger.current_unhealthy``, the injected clock
    driven as ``gw.step(); rec.tick()``, ``SloBurnEngine`` and
    ``MemWatch`` on the gateway, a ``Tracer`` wired through the pool.
    ``waves[0]`` is submitted at once under ``slo_s`` and pumped until
    the pool is back at one replica; then (``fault``) the last live
    replica's label is marked unhealthy, ``waves[1]`` submitted, and the
    label healed once the wave is dispatched elsewhere; then pumped
    until idle.  Returns (gateway, reconciler, tracer, record): per
    tick the ledger's owned labels against the live replicas' labels,
    per pump step MemWatch's units against the live replicas, the heals
    taken, the alerts and the burn engine."""
    from k8s_dra_driver_tpu_torch.cluster.bus import EventBus
    from k8s_dra_driver_tpu_torch.fleet import (ChipLedger, FleetPolicy,
                                                FleetReconciler, PolicyConfig)
    from k8s_dra_driver_tpu_torch.gateway import (FleetGateway, ReplicaManager,
                                                  SloBurnEngine)
    from k8s_dra_driver_tpu_torch.sim.clock import VirtualClock
    from k8s_dra_driver_tpu_torch.utils.memwatch import MemWatch
    from k8s_dra_driver_tpu_torch.utils.tracing import Tracer
    clock = VirtualClock()
    health: dict = {}
    ledger = ChipLedger([0, 1, 2, 3], health_source=lambda: dict(health))
    healed = []
    take = ledger.take_healed

    def take_healed():
        out = take()
        if out:
            healed.append(sorted(out))
        return out

    ledger.take_healed = take_healed
    mgr = ReplicaManager(make_engine, replicas=1,
                         health_source=ledger.current_unhealthy,
                         chip_of=lambda name: 3, depth_bound=8)
    bus = EventBus(seed=0)
    tracer = Tracer(bus=bus, clock=clock)
    mw = MemWatch()
    burn = SloBurnEngine()
    gw = FleetGateway(mgr, queue_capacity=64, clock=clock,
                      auto_replace=False, bus=bus, tracer=tracer, burn=burn,
                      memwatch=mw, tenant="serve")
    rec = FleetReconciler(gw, ledger=ledger, clock=clock, tracer=tracer,
                          policy=FleetPolicy(PolicyConfig(
                              queue_high=4, up_after=1, down_after=3,
                              min_replicas=1, max_replicas=3)))
    alerts = []
    bus.subscribe("alert", lambda ev: alerts.append(dict(ev.payload)))
    owners, units = [], []

    def live():
        return [r for r in mgr.replicas if r.state != "dead"]

    def cycle():
        gw.step()
        units.append((sorted({k.split("/")[1] for k in
                              mw.snapshot()["components"]}),
                      sorted(r.name for r in live())))
        rec.tick()
        owners.append((sorted(c for c, o in ledger.owners.items() if o),
                       sorted(r.chip for r in live())))
        clock.t += CTL_DT

    def pump_until(done):
        for _ in range(CTL_MAX_CYCLES):
            if done():
                return
            cycle()
        fail(f"control loop: not settled in {CTL_MAX_CYCLES} cycles "
             f"(events {rec.events})")

    def idle():
        return not gw.pending() and not any(r.in_flight for r in live())

    for r in waves[0]:
        g = gw.submit(r, slo_s=slo_s)
        if g.status != "queued":
            fail(f"control loop: {r.uid} refused at the door ({g.status})")
    pump_until(lambda: idle() and len(live()) == 1)
    if fault:
        sick = live()[-1]
        health[sick.chip] = "uncorrectable ECC (scripted)"
        for r in waves[1]:
            gw.submit(r, slo_s=600.0)
        # heal once the sick replica is reaped and the wave is placed
        # on the replica that took its place
        pump_until(lambda: sick not in mgr.replicas and not gw.pending()
                   and all(r.uid in gw.outcomes or any(
                       r.uid in x.in_flight for x in live())
                       for r in waves[1]))
        health.clear()
    pump_until(idle)
    for _ in range(2):
        cycle()             # the heal is taken on the next tick
    return gw, rec, tracer, dict(owners=owners, units=units, healed=healed,
                                 alerts=alerts, burn=burn, mw=mw)


def check_control_loop(gw, rec, record, reqs, label, n_replicas_max=3):
    """The 1x1 loop's gates (phase_fleet_control (a)); returns the
    events' kinds."""
    kinds = [k for _, k, _ in rec.events]
    if "scale_up" not in kinds or "scale_down" not in kinds:
        fail(f"{label}: no scale-up or no scale-down in {rec.events}")
    downs = [i["replica"] for _, k, i in rec.events if k == "scale_down"]
    retired = [i["replica"] for _, k, i in rec.events if k == "retired"]
    if sorted(downs) != sorted(retired):
        fail(f"{label}: drained {downs} but retired {retired}")
    reaped = [i for _, k, i in rec.events if k == "reap_dead"]
    if len(reaped) != 1:
        fail(f"{label}: {len(reaped)} replicas reaped, expected the sick "
             f"one once: {rec.events}")
    if record["healed"] != [[reaped[0]["chip"]]]:
        fail(f"{label}: heals taken {record['healed']}, expected "
             f"[[{reaped[0]['chip']}]] once")
    bad = [(t, o) for t, o in enumerate(record["owners"]) if o[0] != o[1]]
    if bad:
        fail(f"{label}: ledger owners != live replicas' labels at ticks "
             f"{bad[:3]}")
    bad = [(t, u) for t, u in enumerate(record["units"]) if u[0] != u[1]]
    if bad:
        fail(f"{label}: MemWatch units != live replicas at steps {bad[:3]}")
    return kinds


def phase_fleet_control(cfg, reqs, fa, pa) -> dict:
    """The fleet control loop on the card at the 154M, params made here
    from generator seed 0.

    (a) ``FleetReconciler`` over a ``FleetGateway`` of 8-slot f32 paged
    engines (``control_loop``): the first 16 requests of s8_r24 as a
    burst under a CTL_TIGHT_SLO_S deadline, calm, then the last live
    replica's label marked unhealthy with the last 8 submitted, and
    healed.  Gated: every uid finished exactly once; every stream
    byte-equal to one f32 paged engine draining s8_r24; at least one
    scale-up and every scale-down drained then retired; the ledger's
    owned labels equal the live replicas' after every tick; the sick
    replica reaped once and the heal taken once; MemWatch's units equal
    the live replicas after every pump step; at least one burn-rate
    alert, and none in a control run of the same burst under a 600 s
    deadline; K2 n_layers a paged step and K1 n_layers a fresh prefill.
    Then: ``critical_path`` of every uid that was never requeued sums
    its parts to its wall within 1e-6 s; ``export_chrome`` twice is
    byte-equal; ``rec.serve_metrics`` serves ``tpu_fleet_ticks_total``,
    ``tpu_gateway_queue_depth`` and ``tpu_mem_accounted_frac`` on one GET
    of ``/metrics``.  The action timeline is printed.  (b)
    ``MultiTenantReconciler`` over two serving tenants of 8-slot bf16
    paged engines (``two_tenant_loop``): hi (priority 2, floor 1) bursts
    s8_r24 against lo (priority 1, floor 1, two
    replicas whose engines each carry an ``AdapterPool`` of MT_ADAPTERS
    cold rank-MT_RANK adapters, quota one slot).  Gated: every adapter
    eviction before any chip action; every reclaim taken from lo for hi,
    lo never below its floor; a grant to hi; a release in calm; every
    uid of both tenants finished exactly once; K2 n_layers a paged step
    and K1 n_layers a fresh prefill.  ``fairshare_error()`` printed.
    Returns the phase's K1 and K2 launches."""
    import urllib.request

    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    from k8s_dra_driver_tpu_torch.utils import dispatch
    from k8s_dra_driver_tpu_torch.utils.tracing import (critical_path,
                                                        export_chrome)
    t_phase = time.perf_counter()
    total = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = init_params(cfg32, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")

    def f32_paged(name=None):
        return ServingEngine(params32, cfg32, slots=8, top_k=50,
                             kv_layout="paged")

    oracle, counts, _, _ = drain(ServingEngine, params32, cfg32, reqs, fa, pa,
                                 "control oracle f32 paged", top_k=50,
                                 kv_layout="paged")
    add(counts)
    waves = (reqs[:16], reqs[16:])

    # (a) the 1x1 loop, then its calm control run
    zero_serving_counts(fa, pa)
    t0 = time.perf_counter()
    with dispatch.track() as t:
        gw, rec, tracer, record = control_loop(f32_paged, waves,
                                               CTL_TIGHT_SLO_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_snapshot(fa, pa)
    add(counts)
    require_fwd_route(fa, "control (a)", False)
    fleet_exactly_once(gw, reqs, "control (a)")
    equal = fleet_byte_equal(gw, oracle, "control (a)", gate=True)
    kinds = check_control_loop(gw, rec, record, reqs, "control (a)")
    check = kv_kernel_counts(cfg, counts, t.by_label, "control (a)")
    if not record["alerts"]:
        fail("control (a): the burst under a tight deadline fired no "
             "burn-rate alert")
    timeline = [(t_, k, i.get("replica"), i.get("chip"))
                for t_, k, i in rec.events]
    print(f"control (a) 1x1 loop ({card_line()}): f32 paged, exactly once "
          f"{len(reqs)}/{len(reqs)}, {equal}/{len(reqs)} streams = the f32 "
          f"paged oracle (gated); {check}; {len(record['owners'])} ticks in "
          f"{wall:.3f} s wall; ledger owners = live replicas' labels every "
          f"tick, MemWatch units = live replicas every step, reaped once, "
          f"healed once {record['healed']} (gated); burn-rate alerts "
          f"{len(record['alerts'])} (first {record['alerts'][0]})",
          flush=True)
    print(f"control (a) action timeline (fake s, kind, replica, label): "
          f"{timeline}", flush=True)
    parts = ("queue_wait", "prefill", "migrate", "decode", "drain_gap")
    worst, longest = 0.0, None
    for uid, g in gw.outcomes.items():
        if g.requeues:
            continue
        cp = critical_path(tracer.spans, f"t-{uid}")
        if cp["spans"] < 2:
            fail(f"control (a): {uid} has {cp['spans']} spans")
        worst = max(worst, abs(sum(cp[p] for p in parts) - cp["total"]))
        if longest is None or cp["total"] > longest[1]["total"]:
            longest = (uid, cp)
    if worst > 1e-6:
        fail(f"control (a): a critical path's parts miss its wall by "
             f"{worst} s")
    first, second = export_chrome(tracer.spans), export_chrome(tracer.spans)
    if first != second:
        fail("control (a): two Chrome-trace exports differ")
    endpoint = rec.serve_metrics("127.0.0.1:0")
    try:
        with urllib.request.urlopen(f"http://{endpoint.address}/metrics",
                                    timeout=10) as resp:
            body = resp.read().decode()
    finally:
        endpoint.stop()
    for family in ("tpu_fleet_ticks_total", "tpu_gateway_queue_depth",
                   "tpu_mem_accounted_frac"):
        if f"# TYPE {family}" not in body:
            fail(f"control (a): /metrics lacks {family}")
    frac = metric_value(body, r"^tpu_mem_accounted_frac (\S+)$")
    print(f"control (a) spans: {len(tracer.spans)} (kept), critical path "
          f"parts = wall within {worst:.2e} s over every unrequeued uid "
          f"(gated), longest {longest[0]} {longest[1]}; export_chrome "
          f"{len(first)} bytes, twice equal (gated); /metrics {len(body)} "
          f"bytes with the fleet, gateway and MemWatch families (gated), "
          f"tpu_mem_accounted_frac {frac}", flush=True)
    del gw, rec, tracer, record, first, second, body

    zero_serving_counts(fa, pa)
    gw, rec, _, record = control_loop(f32_paged, waves, 600.0, fault=False)
    torch.cuda.synchronize()
    add(kernel_snapshot(fa, pa))
    if record["alerts"]:
        fail(f"control (a): the calm control run fired {record['alerts']}")
    print(f"control (a) calm control run: 600 s deadline, no burn-rate "
          f"alert (gated), {len(gw.outcomes)} outcomes, actions "
          f"{[k for _, k, _ in rec.events]}", flush=True)
    del gw, rec, record, params32, oracle

    # (b) two tenants
    zero_serving_counts(fa, pa)
    t0 = time.perf_counter()
    with dispatch.track() as t:
        out = two_tenant_loop(cfg, reqs)
    torch.cuda.synchronize()
    counts = kernel_snapshot(fa, pa)
    add(counts)
    require_fwd_route(fa, "control (b)", True)
    check = kv_kernel_counts(cfg, counts, t.by_label, "control (b)")
    print(f"control (b) two tenants ({card_line()}): bf16 paged, "
          f"{out['line']}; {check}; {time.perf_counter() - t0:.3f} s wall",
          flush=True)
    print(f"control (b) action timeline (fake s, kind, tenant, replica): "
          f"{out['timeline']}", flush=True)
    print(f"control phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


def two_tenant_loop(cfg, reqs):
    """``MultiTenantReconciler`` over two serving tenants on labels 0-3
    (``TopologyBinPacker`` of one-label domains): hi (priority 2, quota
    3, floor 1) with one replica on label 3, lo (priority 1, quota 3,
    floor 1, adapter quota one slot) with two on labels 0 and 1, each of
    lo's engines carrying its own ``AdapterPool`` of MT_ADAPTERS cold
    adapters of tenant lo.  hi takes ``reqs`` as a burst under
    ``burst_slo_s``, lo a third of them; pumped until both are idle and
    hi is back at its floor.  Fails on a broken gate; returns the
    printed line and the timeline."""
    from k8s_dra_driver_tpu_torch.fleet import (ChipLedger, MtConfig,
                                                MultiTenantReconciler,
                                                ServingTenant, TenantRegistry,
                                                TenantSpec, TopologyBinPacker)
    from k8s_dra_driver_tpu_torch.gateway import FleetGateway, ReplicaManager
    from k8s_dra_driver_tpu_torch.models.serving import Request, ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    from k8s_dra_driver_tpu_torch.serving_lora import (AdapterManifest,
                                                       AdapterPool,
                                                       make_adapter)
    from k8s_dra_driver_tpu_torch.sim.clock import VirtualClock
    clock = VirtualClock()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")

    def lo_pool():
        pool = AdapterPool(cfg, MT_RANK, n_resident=MT_ADAPTERS)
        for i in range(MT_ADAPTERS):
            name = f"lo{i}"
            pool.register(AdapterManifest(
                name, MT_RANK, tenant="lo",
                source=make_adapter(cfg, MT_RANK, seed=500 + i)))
            pool.release(pool.acquire(name))
        return pool

    chips = {"hi": {"r0": 3}, "lo": {"r0": 0, "r1": 1}}

    def gateway(tenant, n, pools):
        mgr = ReplicaManager(
            lambda name: ServingEngine(
                params, cfg, slots=8, top_k=50, kv_layout="paged",
                adapter_pool=lo_pool() if pools else None),
            replicas=n, chip_of=chips[tenant].get, depth_bound=8)
        return FleetGateway(mgr, queue_capacity=64, clock=clock,
                            auto_replace=False, tenant=tenant)

    gws = {"hi": gateway("hi", 1, False), "lo": gateway("lo", 2, True)}
    bytes_per_slot = gws["lo"].manager.replicas[0].engine \
        .adapter_pool.bytes_per_slot
    registry = TenantRegistry(capacity=4)
    registry.add(TenantSpec("hi", priority=2, quota=3, floor=1),
                 ServingTenant(gws["hi"]))
    registry.add(TenantSpec("lo", priority=1, quota=3, floor=1,
                            adapter_quota_bytes=bytes_per_slot),
                 ServingTenant(gws["lo"]))
    ledger = ChipLedger([0, 1, 2, 3])
    rec = MultiTenantReconciler(
        registry, ledger=ledger,
        packer=TopologyBinPacker(ledger, domain_size=1),
        config=MtConfig(queue_high=4, up_after=1, down_after=3),
        clock=clock)
    lo_reqs = [Request(uid=f"lo-{r.uid}", prompt=r.prompt, max_new=r.max_new,
                       temperature=r.temperature, seed=r.seed)
               for r in reqs[::3]]
    held, errs = [], []

    def idle(gw):
        return not gw.pending() and not any(
            r.in_flight for r in gw.manager.replicas)

    def pump_until(done):
        for _ in range(CTL_MAX_CYCLES):
            if done():
                return
            for gw in gws.values():
                gw.step()
            rec.tick()
            held.append({t: sorted(registry.workload(t).chips())
                         for t in gws})
            errs.append(rec.fairshare_error())
            clock.t += CTL_DT
        fail(f"control (b): not settled in {CTL_MAX_CYCLES} cycles "
             f"(events {rec.events})")

    for r in lo_reqs:
        gws["lo"].submit(r, slo_s=600.0)
    for r in reqs:
        gws["hi"].submit(r, slo_s=600.0)
    pump_until(lambda: all(idle(gw) for gw in gws.values())
               and len(held[-1]["hi"]) == 1)
    kinds = [(k, i.get("tenant"), i.get("beneficiary"))
             for _, k, i in rec.events]
    evicts = [n for n, (k, _, _) in enumerate(kinds) if k == "adapter_evict"]
    chip_acts = [n for n, (k, _, _) in enumerate(kinds)
                 if k in ("grant", "reclaim_drain", "reclaim_shrink",
                          "reclaim_park", "release")]
    if not evicts or not chip_acts or max(evicts) > min(chip_acts):
        fail(f"control (b): adapter evictions {evicts} must all come "
             f"before the first chip action {chip_acts[:1]}: {kinds}")
    reclaims = [x for x in kinds if x[0].startswith("reclaim")]
    if not reclaims or any(x[1:] != ("lo", "hi") for x in reclaims):
        fail(f"control (b): reclaims {reclaims}, expected from lo for hi")
    if ("grant", "hi", None) not in kinds or not any(
            k == "release" for k, _, _ in kinds):
        fail(f"control (b): no grant to hi or no calm release: {kinds}")
    if min(len(h["lo"]) for h in held) < 1:
        fail("control (b): lo fell below its floor of 1 label")
    for tenant, want in (("hi", reqs), ("lo", lo_reqs)):
        fleet_exactly_once(gws[tenant], want, f"control (b) {tenant}")
    evicted = sum(len(i.get("adapters", [])) for _, k, i in rec.events
                  if k == "adapter_evict")
    timeline = [(t_, k, i.get("tenant"), i.get("replica"))
                for t_, k, i in rec.events]
    line = (f"{evicted} adapters evicted before any chip action, reclaims "
            f"{len(reclaims)} all from lo for hi, lo held >= 1 label, a "
            f"grant and a release, exactly once hi {len(reqs)}/{len(reqs)} "
            f"and lo {len(lo_reqs)}/{len(lo_reqs)} (gated); peak hi labels "
            f"{max(len(h['hi']) for h in held)}; fairshare_error max "
            f"{max(errs):.4f}, last {errs[-1]:.4f} over {len(errs)} ticks")
    return {"line": line, "timeline": timeline}


def zero_counts(fa) -> None:
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    fa.tc_launches = fa.dq_tc_launches = fa.dkv_tc_launches = 0
    fa.block_launches = fa.block_tc_launches = 0


def flash_routes(fa) -> dict:
    """K1, K3 and K4 launches by route: tensor cores (bf16) and CUDA
    cores (f32)."""
    return {"flash_fwd_tc": fa.tc_launches,
            "flash_fwd_f32": fa.launches - fa.tc_launches,
            "flash_bwd_dq_tc": fa.dq_tc_launches,
            "flash_bwd_dkv_tc": fa.dkv_tc_launches,
            "flash_bwd_dq_f32": fa.dq_launches - fa.dq_tc_launches,
            "flash_bwd_dkv_f32": fa.dkv_launches - fa.dkv_tc_launches}


def require_routes(fa, label: str, tc: int, f32: int,
                   fwd: tuple | None = None) -> dict:
    """Fail unless K3 and K4 each launched ``tc`` times on the
    tensor-core route and ``f32`` times on the f32 route since the
    counters were zeroed, and K1 ``fwd`` = (tensor-core, f32) times (by
    default as K3); returns the routes' counts."""
    fwd_tc, fwd_f32 = fwd if fwd is not None else (tc, f32)
    routes = flash_routes(fa)
    want = {"flash_fwd_tc": fwd_tc, "flash_fwd_f32": fwd_f32,
            "flash_bwd_dq_tc": tc, "flash_bwd_dkv_tc": tc,
            "flash_bwd_dq_f32": f32, "flash_bwd_dkv_f32": f32}
    print(f"{label}: K1/K3/K4 launches by route {routes} (expected "
          f"{want})", flush=True)
    if routes != want:
        fail(f"{label}: K1/K3/K4 took the routes {routes}, expected {want}")
    return routes


def require_fwd_route(fa, label: str, tc: bool) -> None:
    """Fail unless every K1 launch since the counters were zeroed took
    the tensor-core route (``tc``, bf16) or every one the CUDA-core
    route (f32)."""
    if fa.tc_launches != (fa.launches if tc else 0):
        fail(f"{label}: {fa.tc_launches} of {fa.launches} K1 launches on "
             f"the tensor-core route, expected "
             f"{'all' if tc else 'none'}")


def require_gmm_routes(gm, label: str, tc: int, f32: int, dw_tc: int,
                       dw_f32: int) -> dict:
    """Fail unless K5 launched ``tc`` times on the tensor-core route and
    ``f32`` times on the CUDA-core route since the counters were
    zeroed, and K6 ``dw_tc`` and ``dw_f32`` times; returns the routes'
    counts."""
    routes = {"gmm_tc": gm.tc_launches,
              "gmm_f32": gm.launches["gmm"] - gm.tc_launches,
              "gmm_dw_tc": gm.dw_tc_launches,
              "gmm_dw_f32": gm.launches["gmm_dw"] - gm.dw_tc_launches}
    want = {"gmm_tc": tc, "gmm_f32": f32, "gmm_dw_tc": dw_tc,
            "gmm_dw_f32": dw_f32}
    print(f"{label}: K5/K6 launches by route {routes} (expected {want})",
          flush=True)
    if routes != want:
        fail(f"{label}: K5/K6 took the routes {routes}, expected {want}")
    return routes


def train_counts(fa) -> dict:
    return {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
            "flash_bwd_dkv": fa.dkv_launches}


def step_param_errors(p_c, p_h, g_h) -> tuple[float, float, int]:
    """Card-vs-CPU parameters after one AdamW step: (largest difference
    outside the noise band, largest inside it, entries inside it).  The
    band holds the entries whose CPU gradient is nonzero and below
    NOISE_BAND of its tensor's largest entry: there the gradient is f32
    rounding noise around zero, which AdamW's first update
    lr * g / (|g| + eps) turns into an arbitrary fraction of a step, so
    callers hold those entries to two steps."""
    strict = noisy = 0.0
    n_noisy = 0
    for a, b, g in zip(p_c, p_h, g_h):
        band = (g != 0) & (g.abs() < NOISE_BAND * g.abs().max())
        n_noisy += int(band.sum())
        diff = (a - b).abs()
        strict = max(strict, float(diff[~band].max()) if (~band).any()
                     else 0.0)
        noisy = max(noisy, float(diff[band].max()) if band.any() else 0.0)
    return strict, noisy, n_noisy


def small_train_config():
    """The f32 2-layer config of the card-vs-CPU steps."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        TransformerConfig)
    return TransformerConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_head=64, d_ff=512, max_seq=256,
                             dtype=torch.float32)


def small_batch(cfg):
    """The small steps' global batch: tokens and packed segments [2,
    256] from numpy seed 5."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (2, 256)).astype(np.int32)
    seg = np.cumsum(rng.integers(0, 64, (2, 256)) == 0, axis=1).astype(
        np.int32)
    return tokens, seg


def small_step(cfg, device, tokens, seg, mesh=None):
    """One AdamW step of ``cfg`` from generator seed 3 on ``device``
    (over ``mesh`` when given): (loss, parameters after the step,
    gradients), the tensors on the host."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        make_train_step, named_tensors)
    step, init_state = make_train_step(cfg, device=device, mesh=mesh)
    params, opt = init_state(torch.Generator().manual_seed(3))
    params, opt, loss = step(params, opt, tokens, seg)
    leaves = named_tensors(params)
    missing = [n for n, t in leaves if t.grad is None]
    if missing:
        fail(f"train step on {device}: no gradient for {missing}")
    return (float(loss), [t.detach().cpu() for _, t in leaves],
            [t.grad.detach().cpu() for _, t in leaves])


def phase_train_small(fa) -> dict:
    """One f32 AdamW step of a small config on the card (K1/K3/K4) and
    on the CPU (plain versions), from the same parameters and tokens,
    with packed segments; parameters compared by
    :func:`step_param_errors`.  Returns the card step's K3/K4 launches
    by route (all on the f32 route)."""
    cfg = small_train_config()
    tokens, seg = small_batch(cfg)
    results = {}
    for device in ("cuda", "cpu"):
        zero_counts(fa)
        loss, params, grads = small_step(cfg, device, tokens, seg)
        if device == "cuda":
            routes = require_routes(fa, "train f32 small step", 0,
                                    cfg.n_layers)
        results[device] = (loss, params, grads, train_counts(fa))
    (l_c, p_c, _, counts), (l_h, p_h, g_h, _) = (results["cuda"],
                                                 results["cpu"])
    if min(counts.values()) != cfg.n_layers:
        fail(f"small f32 step launched {counts}: each kernel once per "
             f"layer expected")
    loss_rel = abs(l_c - l_h) / abs(l_h)
    strict, noisy, n_noisy = step_param_errors(p_c, p_h, g_h)
    ok = (loss_rel <= STEP_LOSS_RTOL and strict <= STEP_PARAM_ATOL
          and noisy <= 2 * 3e-4)
    print(f"train f32 small step, card (kernels) vs CPU (plain): loss "
          f"{l_c:.7f} vs {l_h:.7f} (rel {loss_rel:.3g}, tol "
          f"{STEP_LOSS_RTOL}); params max|d| {strict:.3g} (tol "
          f"{STEP_PARAM_ATOL}), {n_noisy} noise-band entries max|d| "
          f"{noisy:.3g} (tol 6e-4); launches {counts} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the card's f32 train step disagrees with the CPU's")
    return routes


def state_snapshot(params, opt) -> list:
    """Every tensor of (params, optimizer state) copied, in a fixed
    order, for a bitwise comparison."""
    from k8s_dra_driver_tpu_torch.models.transformer import named_tensors
    out = [t.detach().clone() for _, t in named_tensors(params)]
    state = opt.state_dict()["state"]
    for i in sorted(state):
        for key in sorted(state[i]):
            out.append(torch.as_tensor(state[i][key]).detach().clone())
    return out


def phase_train(fa, tmp: Path, record: dict) -> dict:
    """The 154M configuration trained at full width: TRAIN_STEPS AdamW
    steps of B=8 x T=2048 with the K1/K3/K4 counters zeroed just before
    and read just after, a checkpoint at TRAIN_SAVE_AT, the resume
    check, and one step under remat.  Returns the steps' launches;
    ``record`` gets the losses and the first SP_STEPS batches, which
    the sp phase trains again."""
    from k8s_dra_driver_tpu_torch.models.checkpoint import (
        TrainCheckpointer)
    from k8s_dra_driver_tpu_torch.models.data import (BatchLoader,
                                                      load_token_file,
                                                      write_token_file)
    from k8s_dra_driver_tpu_torch.models.transformer import make_train_step
    cfg = serving_config()
    # a repeated 32-token motif (as the JAX package's training probe
    # builds its corpus), two epochs of 16 windows
    motif = np.random.default_rng(0).integers(0, cfg.vocab, 32)
    corpus = np.tile(motif, 2 * TRAIN_B * TRAIN_T // 32)
    path = write_token_file(corpus, tmp / "corpus.bin", cfg.vocab)

    def loader():
        return BatchLoader(load_token_file(path, cfg.vocab), batch=TRAIN_B,
                           seq_len=TRAIN_T, seed=0)

    step, init_state = make_train_step(cfg, device="cuda")
    params, opt = init_state(torch.Generator(device="cuda").manual_seed(0))
    data = loader()
    ckpt = TrainCheckpointer(tmp / "ckpt", keep=2)
    losses, walls, saved = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    record["batches"] = []
    for i in range(1, TRAIN_STEPS + 1):
        batch = next(data)
        if i <= SP_STEPS:
            record["batches"].append(batch)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))          # waits for the step
        walls.append(time.perf_counter() - t0)
        if i == TRAIN_SAVE_AT:
            ckpt.save(i, params, opt, extra=data.state_dict())
            saved = state_snapshot(params, opt)
    counts = train_counts(fa)
    record["losses"] = losses
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = walls[1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    print(f"train 154M B={TRAIN_B} T={TRAIN_T} bf16: losses "
          f"{[round(x, 5) for x in losses]}; step wall ms "
          f"{[round(1e3 * w, 1) for w in walls]} (mean of steps 2-"
          f"{TRAIN_STEPS}: {step_ms:.1f} ms = "
          f"{TRAIN_B * TRAIN_T / (step_ms / 1e3):.0f} tokens/s); peak "
          f"device memory {peak_gb:.2f} GiB; kernel launches {counts}",
          flush=True)
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall: {losses}")
    if min(counts.values()) <= 0:
        fail(f"training launched {counts}: every kernel must be > 0")
    counts.update(require_routes(fa, "train 154M",
                                 cfg.n_layers * TRAIN_STEPS, 0))

    # resume: a fresh state from another seed, restored from step 3
    params2, opt2 = init_state(torch.Generator(device="cuda").manual_seed(9))
    params2, opt2, at = ckpt.restore(params2, opt2)
    restored = state_snapshot(params2, opt2)
    same = (at == TRAIN_SAVE_AT and len(restored) == len(saved)
            and all(a.dtype == b.dtype and a.device == b.device
                    and torch.equal(a, b)
                    for a, b in zip(restored, saved)))
    data2 = loader()
    data2.load_state_dict(ckpt.restore_extra(at))
    resumed = []
    for _ in range(TRAIN_SAVE_AT, TRAIN_STEPS):
        params2, opt2, loss = step(params2, opt2, next(data2))
        resumed.append(float(loss))
    ckpt.close()
    gap = max(abs(a - b) for a, b in zip(resumed, losses[TRAIN_SAVE_AT:]))
    ok = same and gap <= RESUME_TOL
    print(f"train resume from step {at}: {len(saved)} tensors bitwise "
          f"equal={same}; losses {[round(x, 5) for x in resumed]} vs "
          f"{[round(x, 5) for x in losses[TRAIN_SAVE_AT:]]} (max|d| "
          f"{gap:.3g}, tol {RESUME_TOL}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("the restored training state or its losses disagree")
    del saved, restored

    # remat: the layer forward runs again in the backward, so K1 twice
    step_r, _ = make_train_step(dataclasses.replace(cfg, remat=True),
                                device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    t0 = time.perf_counter()
    params2, opt2, loss = step_r(params2, opt2, next(data2))
    remat_loss = float(loss)
    remat_ms = 1e3 * (time.perf_counter() - t0)
    remat_counts = train_counts(fa)
    remat_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    print(f"train remat step: loss {remat_loss:.5f}, wall {remat_ms:.1f} "
          f"ms, peak device memory {remat_gb:.2f} GiB, launches "
          f"{remat_counts} (expected {want})", flush=True)
    if remat_counts != want or not np.isfinite(remat_loss):
        fail("the remat step's launches or loss are wrong")
    require_routes(fa, "train remat step", cfg.n_layers, 0,
                   fwd=(2 * cfg.n_layers, 0))
    return counts


#: the gang recovery phase: the kill arc's steps, the checkpoint cadence,
#: the f32 arc's batch, and the tolerance of its losses against an
#: uninterrupted dp=4 run (summation order only: a dp change is a
#: placement change)
GANG_STEPS = 8
GANG_EVERY = 2
GANG_F32_B, GANG_F32_T = 4, 512
GANG_F32_RTOL = 1e-4
#: live bytes a parked gang may leave behind, over the pre-begin reading
GANG_PARK_SLACK = 16 * 2 ** 20
#: the wedge arc's step deadline: this many steady dp=4 step walls, and
#: never under GANG_MIN_DEADLINE_S
GANG_DEADLINE_X = 5.0
GANG_MIN_DEADLINE_S = 1.0


class TimedSaves:
    """Wraps a checkpointer's ``save`` and ``restore``: each save that
    wrote a generation records (step, bytes, ms), each skipped one
    (step already committed) is counted, each restore records (step,
    ms)."""

    def __init__(self, ckpt):
        self.ckpt = ckpt
        self.saves, self.skipped, self.restores = [], 0, []
        save, restore = ckpt.save, ckpt.restore

        def timed_save(step, params, opt, wait=True, extra=None, mesh=None):
            before = set(ckpt.all_steps())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(step, params, opt, wait=wait, extra=extra, mesh=mesh)
            ms = 1e3 * (time.perf_counter() - t0)
            if step in before:
                self.skipped += 1
            else:
                self.saves.append((step, generation_bytes(ckpt, step), ms))

        def timed_restore(params, opt, step=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = restore(params, opt, step=step)
            torch.cuda.synchronize()
            self.restores.append((out[2], 1e3 * (time.perf_counter() - t0)))
            return out

        ckpt.save, ckpt.restore = timed_save, timed_restore

    def line(self) -> str:
        gens = ", ".join(
            f"step {s}: {b / 2 ** 20:.1f} MiB in {ms:.0f} ms "
            f"({b / 2 ** 20 / (ms / 1e3):.0f} MiB/s)"
            for s, b, ms in self.saves)
        rest = ", ".join(f"step {s} in {ms:.0f} ms" for s, ms in
                         self.restores)
        return (f"generations written [{gens}]; {self.skipped} saves of a "
                f"committed step skipped; restores [{rest}]")


def generation_bytes(ckpt, step: int) -> int:
    """Bytes of one committed generation on disk."""
    from k8s_dra_driver_tpu_torch.parallel.resharding import (
        ShardedCheckpointer)
    if isinstance(ckpt, ShardedCheckpointer):
        root = ckpt.step_path(step)
    else:
        root = ckpt.directory / str(step)
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file())


def timed_job(cfg, corpus, batch: int, seq_len: int, walls: list):
    """``ElasticTrainJob`` on this card over 4 chip slots whose train
    step appends ``(dp, wall seconds)`` to ``walls`` (the card
    synchronized before the clock reads)."""
    from k8s_dra_driver_tpu_torch.parallel.supervisor import (
        ElasticTrainJob)

    class Job(ElasticTrainJob):
        def build(self, dp, exclude_chips=frozenset(), tp=None):
            gang, step, init_state = super().build(dp, exclude_chips, tp)

            def timed(params, opt, tokens):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(params, opt, tokens)
                torch.cuda.synchronize()
                walls.append((dp, time.perf_counter() - t0))
                return out

            return gang, timed, init_state

    return Job(cfg, corpus, batch=batch, seq_len=seq_len, chips=4, tp=1,
               device="cuda")


def steady_ms(walls, dp: int) -> float:
    """Mean wall of the steps at ``dp`` past the first of each
    formation at that width."""
    runs, prev = [], None
    for d, w in walls:
        if d == dp and prev == dp:
            runs.append(w)
        prev = d
    if not runs:
        fail(f"gang: no steady step at dp={dp}")
    return 1e3 * sum(runs) / len(runs)


def gang_supervisor(job, ckpt, coord: Path, *, plan=None,
                    checkpoint_every: int = GANG_EVERY,
                    step_deadline_s: float = 60.0):
    from k8s_dra_driver_tpu_torch.parallel.supervisor import GangSupervisor
    return GangSupervisor(job, ckpt, coordination_dir=coord, dp=4,
                          fault_plan=plan, checkpoint_every=checkpoint_every,
                          step_deadline_s=step_deadline_s,
                          first_step_deadline_s=600.0)


def gang_plan(name: str, skip: int, error: str = "crash",
              latency_s: float = 0.0):
    """One fault on gang worker ``name`` after ``skip`` decisions."""
    from k8s_dra_driver_tpu_torch.cluster.faults import FaultPlan, FaultRule
    return FaultPlan([FaultRule(verb="gang", kind="Worker", name=name,
                                skip=skip, times=1, error=error,
                                latency_s=latency_s)])


def gang_corpus(cfg, batch: int, seq_len: int) -> np.ndarray:
    """phase_train's corpus: a repeated 32-token motif, two epochs."""
    motif = np.random.default_rng(0).integers(0, cfg.vocab, 32)
    return np.tile(motif, 2 * batch * seq_len // 32)


def check_kill_arc(sup, report, label: str) -> None:
    """The gates of tests/test_supervisor.py's kill arc."""
    from k8s_dra_driver_tpu_torch.parallel import supervisor as sv
    recs = report.recoveries
    rec = recs[0] if recs else None
    losses = [l for _, l in report.losses]
    reg = sup.metrics.registry
    contract = json.loads((sup.dir / sv.CONTRACT_FILENAME).read_text())
    problems = []
    if len(recs) != 1 or rec.cause != "dead" or rec.victims != ["g0w2"]:
        problems.append(f"recoveries {recs}")
    elif ((rec.from_dp, rec.to_dp) != (4, 2) or rec.restored_step != 4
          or rec.steps_lost > GANG_EVERY or not rec.mttr_s > 0):
        problems.append(f"recovery {rec}")
    if report.transitions != [sv.RUNNING, sv.SUSPECT, sv.EVICT, sv.REFORM,
                              sv.RESUME, sv.RUNNING]:
        problems.append(f"transitions {report.transitions}")
    if [s for s, _ in report.losses] != list(range(1, GANG_STEPS + 1)):
        problems.append(f"steps {[s for s, _ in report.losses]}")
    if not all(np.isfinite(losses)) or not losses[-1] < min(losses[:4]):
        problems.append(f"losses {losses}")
    if (contract["num_workers"], contract["generation"],
            contract["excluded_chips"]) != (2, 1, [2]):
        problems.append(f"contract {contract}")
    want = {("tpu_train_restarts_total", (("cause", "dead"),)): 1,
            ("tpu_train_recovery_seconds_count", ()): 1,
            ("tpu_train_dp_width", ()): 2,
            ("tpu_train_supervisor_state", (("state", sv.RUNNING),)): 1}
    for (name, labels), value in want.items():
        if reg.get_sample_value(name, dict(labels)) != value:
            problems.append(f"{name}{dict(labels)} = "
                            f"{reg.get_sample_value(name, dict(labels))}")
    if reg.get_sample_value("tpu_train_steps_lost_total") > GANG_EVERY:
        problems.append("tpu_train_steps_lost_total")
    if problems:
        fail(f"gang {label}: " + "; ".join(map(str, problems)))


def phase_gang_recovery(fa, pa, tmp: Path) -> tuple[dict, dict]:
    """Training recovery: ``GangSupervisor`` over
    ``ElasticTrainJob(chips=4, device="cuda")`` with the 154M at full
    width (B=8 x T=2048, bf16), every dp row of a step its own forward
    and backward.

    (a) The kill arc (tests/test_supervisor.py's): dp=4,
    ``ShardedCheckpointer`` (keep 2, the transformer's rules), a
    generation every GANG_EVERY steps, GANG_STEPS steps, ``g0w2``
    crashing after 4 decisions.  Gated: one recovery, cause ``dead``,
    victims ``["g0w2"]``, dp 4 → 2, restored step 4, steps lost <=
    GANG_EVERY, MTTR > 0; the transitions RUNNING, SUSPECT, EVICT,
    REFORM, RESUME, RUNNING; steps 1..8 each once, the last loss below
    the pre-kill minimum; the contract file at 2 workers, generation 1,
    chip 2 excluded; ``RecoveryMetrics`` as that test reads it; K1, K3
    and K4 each exactly n_layers x the rows of every step (4 before the
    kill, 2 after), all on the tensor cores.  Printed: MTTR, each
    generation's bytes with its save ms and MiB/s, the restore ms, the
    steady step wall at dp=4 and dp=2.  (b) The wedge: a ``hang`` on
    ``g0w1`` after the two warm-up steps, the step deadline
    GANG_DEADLINE_X steady dp=4 walls: cause ``wedged``, victims
    ``["g0w1"]``, dp 4 → 2, every step once.  (c) Placement, not math:
    the kill arc in f32 at B=4 x T=512, each step's loss within
    GANG_F32_RTOL of an uninterrupted dp=4 run's; then one byte flipped
    in the newest generation's largest shard: ``restore()`` falls back
    to the previous generation and ``read_slice`` of that shard raises
    ``ShardCorruption``.  (d) ``request_width(2)``, ``park()`` and
    ``request_width(4)``, each at a checkpoint step, over
    ``TrainCheckpointer``: zero steps lost, the card's live bytes after
    the park within GANG_PARK_SLACK of the pre-begin reading, the
    unpark restored from the park's step.  (e) ``recovery_probe``,
    ``fleet_probe`` and ``multitenant_probe`` on the card at their
    reference sizes but a head dim of 64 (K1 takes 64 or 128), tp=1:
    ``valid`` gated; MTTR, steps lost, the preempt and cascade ms and
    their K1/K2 launches printed.  Returns (the bf16 arcs' K1/K3/K4
    launches, totals and by route; the f32 ones' by route)."""
    from k8s_dra_driver_tpu_torch.fleet import fleet_probe, multitenant_probe
    from k8s_dra_driver_tpu_torch.models.checkpoint import TrainCheckpointer
    from k8s_dra_driver_tpu_torch.models.layouts import transformer_rules
    from k8s_dra_driver_tpu_torch.models.transformer import TransformerConfig
    from k8s_dra_driver_tpu_torch.parallel import supervisor as sv
    from k8s_dra_driver_tpu_torch.parallel.probe import recovery_probe
    from k8s_dra_driver_tpu_torch.parallel.resharding import (
        ShardCorruption, ShardedCheckpointer)

    cfg = serving_config()
    corpus = gang_corpus(cfg, TRAIN_B, TRAIN_T)
    layers = cfg.n_layers
    t_phase = time.perf_counter()

    # (a) the kill arc, bf16
    walls: list = []
    ckpt = ShardedCheckpointer(tmp / "a", keep=2,
                               rules=transformer_rules(cfg))
    saves = TimedSaves(ckpt)
    sup = gang_supervisor(timed_job(cfg, corpus, TRAIN_B, TRAIN_T, walls),
                          ckpt, tmp / "a-coord",
                          plan=gang_plan("g0w2", 4))
    zero_counts(fa)
    report = sup.run(GANG_STEPS)
    torch.cuda.synchronize()
    check_kill_arc(sup, report, "(a)")
    rows = 4 * 4 + 2 * (GANG_STEPS - 4)
    routes = train_counts(fa)
    routes.update(require_routes(fa, "gang (a) kill arc", layers * rows, 0))
    rec = report.recoveries[0]
    ms4, ms2 = steady_ms(walls, 4), steady_ms(walls, 2)
    print(f"gang (a) 154M bf16 kill arc: dp 4 -> 2 at step "
          f"{rec.restored_step}, steps lost {rec.steps_lost}, MTTR "
          f"{1e3 * rec.mttr_s:.1f} ms; transitions {report.transitions}; "
          f"losses {[round(l, 4) for _, l in report.losses]}; steady "
          f"step wall {ms4:.1f} ms at dp=4, {ms2:.1f} ms at dp=2; "
          f"K1/K3/K4 {layers} x {rows} rows each (gated)", flush=True)
    print(f"gang (a) checkpoints: {saves.line()}", flush=True)
    if not saves.saves or not saves.restores:
        fail("gang (a): no generation written or restored")
    del sup, report, ckpt, saves
    gc.collect()

    # (b) the wedge, bf16
    walls = []
    deadline = max(GANG_MIN_DEADLINE_S, GANG_DEADLINE_X * ms4 / 1e3)
    # the first step past the two warm-up steps hangs (steady deadline)
    plan = gang_plan("g0w1", 2, "hang", 600.0)
    ckpt = TrainCheckpointer(tmp / "b", keep=2)
    sup = gang_supervisor(timed_job(cfg, corpus, TRAIN_B, TRAIN_T, walls),
                          ckpt, tmp / "b-coord", plan=plan,
                          step_deadline_s=deadline)
    zero_counts(fa)
    t0 = time.perf_counter()
    report = sup.run(6)
    wall_b = time.perf_counter() - t0
    ckpt.close()
    recs = report.recoveries
    if (len(recs) != 1 or recs[0].cause != "wedged"
            or recs[0].victims != ["g0w1"]
            or (recs[0].from_dp, recs[0].to_dp) != (4, 2)
            or [s for s, _ in report.losses] != list(range(1, 7))):
        fail(f"gang (b): recoveries {recs}, steps "
             f"{[s for s, _ in report.losses]}")
    for name, n in {**train_counts(fa), **flash_routes(fa)}.items():
        routes[name] += n
    print(f"gang (b) 154M bf16 wedge: step deadline {deadline:.2f} s; "
          f"cause {recs[0].cause}, victims {recs[0].victims}, dp 4 -> 2, "
          f"restored step {recs[0].restored_step}, MTTR "
          f"{1e3 * recs[0].mttr_s:.1f} ms; run {wall_b:.1f} s (gated)",
          flush=True)
    del sup, report, ckpt
    gc.collect()

    # (c) placement, not math, f32
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    corpus32 = gang_corpus(cfg32, GANG_F32_B, GANG_F32_T)
    zero_counts(fa)
    ref = gang_supervisor(
        timed_job(cfg32, corpus32, GANG_F32_B, GANG_F32_T, []),
        TrainCheckpointer(tmp / "c-ref", keep=1), tmp / "c-ref-coord",
        checkpoint_every=10 ** 6)
    ref_losses = [l for _, l in ref.run(GANG_STEPS).losses]
    ref.ckpt.close()
    del ref
    ckpt = ShardedCheckpointer(tmp / "c", keep=2,
                               rules=transformer_rules(cfg32))
    sup = gang_supervisor(
        timed_job(cfg32, corpus32, GANG_F32_B, GANG_F32_T, []), ckpt,
        tmp / "c-coord", plan=gang_plan("g0w2", 4))
    report = sup.run(GANG_STEPS)
    check_kill_arc(sup, report, "(c)")
    losses = [l for _, l in report.losses]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    f32_routes = flash_routes(fa)
    print(f"gang (c) 154M f32 B={GANG_F32_B} T={GANG_F32_T} kill arc "
          f"against an uninterrupted dp=4 run: max relative loss gap "
          f"{rel:.3g} (tol {GANG_F32_RTOL}); losses "
          f"{[round(l, 5) for l in losses]}", flush=True)
    if not rel <= GANG_F32_RTOL:
        fail(f"gang (c): losses {losses} against {ref_losses}")
    newest = ckpt.latest_step()
    leaves = ckpt._read_manifest(ckpt.step_path(newest))["leaves"]
    name, shard = max(((n, sh) for n, e in leaves.items()
                       for sh in e["shards"]),
                      key=lambda kv: kv[1]["nbytes"])
    path = ckpt.step_path(newest) / shard["file"]
    with open(path, "r+b") as f:
        f.seek(shard["nbytes"] // 2)
        byte = f.read(1)
        f.seek(shard["nbytes"] // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    params, opt = sup.init_state(sup._key())
    _, _, at = ckpt.restore(params, opt)
    try:
        ckpt.read_slice(newest, name, bounds=shard["bounds"])
        detected = False
    except ShardCorruption:
        detected = True
    print(f"gang (c) one byte flipped in {shard['file']} "
          f"({shard['nbytes']} bytes) of step {newest}: restore fell back "
          f"to step {at}, read_slice raised ShardCorruption={detected}",
          flush=True)
    if at != ckpt.all_steps()[-2] or not detected:
        fail(f"gang (c): restore at {at} of {ckpt.all_steps()}, "
             f"detected={detected}")
    del sup, report, ckpt, params, opt
    gc.collect()

    # (d) resize, park and unpark at a checkpoint step
    walls = []
    torch.cuda.empty_cache()
    base = allocated()
    ckpt = TrainCheckpointer(tmp / "d", keep=2)
    sup = gang_supervisor(timed_job(cfg, corpus, TRAIN_B, TRAIN_T, walls),
                          ckpt, tmp / "d-coord")
    zero_counts(fa)
    sup.begin(GANG_STEPS)
    while sup._step < GANG_EVERY:
        sup.step_once()
    sup.request_width(2)
    sup.step_once()
    sup.park()
    sup.step_once()
    gc.collect()
    parked = allocated()
    sup.request_width(4)
    sup.step_once()
    while sup.step_once():
        pass
    report = sup.report()
    ckpt.close()
    causes = [(r.cause, r.restored_step, r.steps_lost)
              for r in report.recoveries]
    residue = parked - base
    print(f"gang (d) 154M bf16 request_width(2), park(), request_width(4) "
          f"at step {GANG_EVERY}: recoveries {causes}; live bytes before "
          f"begin {base}, parked {parked} (residue {residue}, slack "
          f"{GANG_PARK_SLACK}); steps {[s for s, _ in report.losses]}",
          flush=True)
    if (causes != [("preempt", GANG_EVERY, 0), ("park", GANG_EVERY, 0),
                   ("expand", GANG_EVERY, 0)]
            or abs(residue) > GANG_PARK_SLACK
            or sv.PARKED not in report.transitions
            or [s for s, _ in report.losses]
            != list(range(1, GANG_STEPS + 1))):
        fail("gang (d): the resize and park arc lost steps or held memory")
    for name, n in {**train_counts(fa), **flash_routes(fa)}.items():
        routes[name] += n
    del sup, report, ckpt
    gc.collect()

    # (e) the probes on the card
    small = TransformerConfig(vocab=64, d_model=256, n_layers=2, n_heads=4,
                              d_head=64, d_ff=64, max_seq=32,
                              dtype=torch.float32)
    for label, fn, keys in (
            ("recovery_probe", recovery_probe,
             ("mttr_ms", "steps_lost_worst")),
            ("fleet_probe", fleet_probe,
             ("scaleup_ms", "preempt_ms", "regrow_ms")),
            ("multitenant_probe", multitenant_probe,
             ("preempt_cascade_ms", "regrow_ms", "frag_win_x",
              "fairshare_err"))):
        zero_counts(fa)
        pa.launches = 0
        out = fn(cfg=small, device="cuda")
        counts = kernel_snapshot(fa, pa)
        print(f"gang (e) {label} on the card (d_head 64, tp={out['tp']}): "
              + ", ".join(f"{k} {out[k]}" for k in keys)
              + f", causes {out.get('recovery_causes', '-')}, K1 "
              f"{counts['flash_fwd']}, K2 {counts['paged_decode']}, valid "
              f"{out['valid']} (gated)", flush=True)
        if not out["valid"] or counts["flash_fwd"] <= 0:
            fail(f"gang (e): {label} {out}")
        for name, n in flash_routes(fa).items():
            f32_routes[name] += n
    print(f"gang phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return routes, f32_routes


#: the crucible's full-width run: the smallest default-schedule length
#: of at least 60 at which the soak passes in either package
#: (tests/test_torch_crucible_soak.py pins it on the CPU)
CRUCIBLE_FULL_CYCLES = 88
CRUCIBLE_SOAK_CYCLES = 220
#: (b)'s gangs: the 154M's widths at this depth.  At all 8 layers the
#: gangs' 79 saves of a 879 MiB generation took about 200 of (b)'s
#: 239-257 s on the H100 and the whole script 958 s of its 1200 s limit
#: (PERF.md section 6); two layers keep every width and cut the bytes
#: to 57%
CRUCIBLE_GANG_LAYERS = 2
#: the four window-triggered double-fault arcs of the default schedule
CRUCIBLE_ARCS = ("mid-chip4-in-reform", "decode-kill-in-handoff",
                 "chip0-in-cascade", "chip1-while-parked")


class ShardedSaveTimer:
    """Times every ``ShardedCheckpointer`` save and restore of a block
    (the class's methods are wrapped, so checkpointers a rig builds are
    covered): each save that wrote a generation records (bytes, ms),
    each successful restore (step, ms)."""

    def __enter__(self):
        from k8s_dra_driver_tpu_torch.parallel.resharding import (
            ShardedCheckpointer)
        self.cls = ShardedCheckpointer
        self.save0, self.restore0 = self.cls.save, self.cls.restore
        self.saves, self.restores = [], []
        timer = self

        def save(ck, step, params, opt_state, wait=True, extra=None,
                 mesh=None):
            before = set(ck.all_steps())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timer.save0(ck, step, params, opt_state, wait=wait, extra=extra,
                        mesh=mesh)
            ms = 1e3 * (time.perf_counter() - t0)
            if step not in before and step in ck.all_steps():
                timer.saves.append((generation_bytes(ck, step), ms))

        def restore(ck, params_like, opt_state_like, step=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = timer.restore0(ck, params_like, opt_state_like, step=step)
            torch.cuda.synchronize()
            timer.restores.append((out[2], 1e3 * (time.perf_counter() - t0)))
            return out

        self.cls.save, self.cls.restore = save, restore
        return self

    def __exit__(self, *exc):
        self.cls.save, self.cls.restore = self.save0, self.restore0
        return False


def crucible_model(cfg, label: str):
    """(cfg, params): ``cfg`` with weights from generator seed 0 on the
    card."""
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    n = sum(p.numel() for p in param_tensors(params))
    print(f"crucible {label}: model {n} parameters, {cfg.dtype}, "
          f"d_head {cfg.d_head}", flush=True)
    return cfg, params


def crucible_gates(label: str, sched, res, rig, cycles: int) -> None:
    """Every assertion of the reference acceptance
    (tests/test_crucible.py test_compound_soak_zero_violations)."""
    bad = [f"cycle {c}: {m}" for c, v in res.violations for m in v]
    from k8s_dra_driver_tpu_torch.cluster import crucible as cru
    from k8s_dra_driver_tpu_torch.cluster import invariants as inv
    if bad:
        fail(f"{label}: {len(bad)} violation(s): {bad[:8]}")
    if not (res.cycles >= cycles and res.survived_cycles == res.cycles):
        fail(f"{label}: survived {res.survived_cycles} of {res.cycles} "
             f"cycles, want {cycles}")
    if set(res.fault_kinds_fired) != set(cru.EVENT_KINDS):
        fail(f"{label}: kinds fired {res.fault_kinds_fired}, want every "
             f"one of {cru.EVENT_KINDS}")
    if res.overlap_hits < 3:
        fail(f"{label}: {res.overlap_hits} overlap hits, want >= 3")
    if res.gang_failures or res.operator_repairs:
        fail(f"{label}: gang failures {res.gang_failures}, operator "
             f"repairs {res.operator_repairs}")
    if not (res.submitted > 0 and res.finished == res.submitted):
        fail(f"{label}: {res.finished} of {res.submitted} finished")
    if not res.compound_mttr_ms > 0:
        fail(f"{label}: no recovery MTTR measured")
    for name, sup in rig.sups.items():
        lost = inv.losses_exactly_once(sup.losses, sup.recoveries)
        if not sup.recoveries or lost:
            fail(f"{label}: gang {name} recoveries {sup.recoveries}, "
                 f"losses {lost}")
    by_id = {e.id: e for e in sched.events}
    for eid in CRUCIBLE_ARCS:
        if by_id[eid].fired_cycle is None or not by_id[eid].hit_windows:
            fail(f"{label}: {eid} fired at {by_id[eid].fired_cycle} in "
                 f"windows {by_id[eid].hit_windows}")
    if rig.burn.cycle < res.cycles or rig.burn.alerts_total:
        fail(f"{label}: burn engine at cycle {rig.burn.cycle}, "
             f"{rig.burn.alerts_total} alerts")
    victims = [info for _, kind, info in rig.rec.events
               if kind.startswith("reclaim") and info.get("tenant") == "hi"]
    if victims:
        fail(f"{label}: the serving tenant was a reclaim victim {victims}")


def crucible_soak(fa, pa, label, cycles, workdir, **kw):
    """One default-schedule soak through ``run_soak`` with the counts
    zeroed just before and read just after; prints the run's line.
    Returns (schedule, result, rig, counts, wall s)."""
    from k8s_dra_driver_tpu_torch.cluster import crucible as cru
    sched = cru.default_schedule(7, cycles=cycles)
    zero_counts(fa)
    pa.launches = 0
    t0 = time.perf_counter()
    res, rig = cru.run_soak(sched, workdir, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**flash_routes(fa), "paged_decode": pa.launches,
              "flash_fwd": fa.launches}
    recs = {name: [(r.cause, r.from_dp, r.to_dp, r.restored_step,
                    r.steps_lost) for r in sup.recoveries]
            for name, sup in rig.sups.items()}
    fired = sorted(res.fault_kinds_fired)
    print(f"crucible {label}: default_schedule(7, cycles={cycles}) in "
          f"{wall:.1f} s ({res.cycles / wall:.2f} cycles/s over "
          f"{res.cycles} cycles with the drain), MTTR "
          f"{res.compound_mttr_ms:.1f} ms, violations "
          f"{sum(len(v) for _, v in res.violations)}, overlap hits "
          f"{res.overlap_hits}, {res.finished}/{res.submitted} finished, "
          f"kinds fired {len(fired)} {fired}, recoveries (cause, from_dp, "
          f"to_dp, restored step, steps lost) {recs}, burn cycle "
          f"{rig.burn.cycle} alerts {rig.burn.alerts_total}, "
          f"step_deadline_s {rig.step_deadline_s} hang_stall_s "
          f"{rig.hang_stall_s}, tier "
          f"corruptions {rig.tier_corruptions}, kv seizures "
          f"{rig.kv_seizures}, adapter storms {rig.adapter_storms}; "
          f"launches {counts}", flush=True)
    return sched, res, rig, counts, wall


def crucible_record(sched, rig) -> dict:
    """What a run must reproduce: each plan's injection log, every
    event's fired cycle and windows, every uid's outcome status and
    every finished token array."""
    plans = {"chip": rig.chip_plan.log, "replica": rig.replica_plan.log,
             **{f"gang-{n}": p.log for n, p in rig.gang_plans.items()}}
    return dict(
        plans={k: list(v) for k, v in plans.items()},
        fired=[(e.id, e.fired_cycle, tuple(e.hit_windows))
               for e in sched.events],
        outcomes={u: g.status for u, g in rig.gw.outcomes.items()},
        tokens={u: np.asarray(f.tokens).tolist()
                for u, f in rig.gw.results.items()})


def phase_crucible(fa, pa, tmp: Path) -> tuple[dict, dict]:
    """The compound-fault crucible on the card
    (``k8s_dra_driver_tpu_torch/cluster/crucible.py``): the full stack
    (a ShardedGateway over a one-prefill, one-decode paged, tiered,
    LoRA-carrying pool, two elastic gangs on ``ShardedCheckpointer``,
    ``MultiTenantReconciler`` over one 8-slot ledger, the burn engine
    and the tracer) in one co-loop under the seeded default schedule.
    The card's kernels take head dims 64 and 128 only, so the
    reference crucible's model (d_head 8) becomes its proportions at
    d_head 64.

    (a) ``default_schedule(7, 220)`` at vocab 64, 2 layers, 4 heads
    over 2 KV heads of 64, d_model 256, d_ff 512, max_seq 48, f32:
    every assertion of the reference acceptance, K1 (f32 route), K2,
    K3 and K4 (f32 route) launched.  (b) The slice at full width:
    engines and oracles on the 154M in f32, the gangs on the 154M's
    widths at CRUCIBLE_GANG_LAYERS layers in bf16,
    ``default_schedule(7, CRUCIBLE_FULL_CYCLES)``: the same gates,
    K1 on both routes and K3/K4 on the tensor cores; the generations'
    count, bytes and save ms, the restores.  (c) The spec-fleet
    schedule (seed 11, 14 cycles, n-gram drafts) twice at (a)'s shape:
    equal injection logs, fired cycles and windows, outcomes and
    tokens; then a repro of it written and replayed, its fired cycles
    equal.  Returns the main-route and f32-route launch counts."""
    from k8s_dra_driver_tpu_torch.cluster import crucible as cru
    from k8s_dra_driver_tpu_torch.cluster.crucible import (FaultEvent,
                                                           Schedule)
    from k8s_dra_driver_tpu_torch.models.transformer import (
        TransformerConfig)
    t_phase = time.perf_counter()
    routes = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0,
              "flash_bwd_dq_tc": 0, "flash_bwd_dkv_tc": 0}
    f32_routes = {"flash_bwd_dq_f32": 0, "flash_bwd_dkv_f32": 0}

    def add(counts):
        for name in routes:
            routes[name] += counts[name]
        for name in f32_routes:
            f32_routes[name] += counts[name]

    # (a) the reference acceptance at d_head 64
    small = crucible_model(TransformerConfig(
        vocab=64, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=64, d_ff=512, max_seq=48, dtype=torch.float32), "(a)")
    sched, res, rig, counts, _ = crucible_soak(
        fa, pa, "(a)", CRUCIBLE_SOAK_CYCLES, tmp / "a", model=small)
    crucible_gates("crucible (a)", sched, res, rig, CRUCIBLE_SOAK_CYCLES)
    if (counts["flash_fwd_f32"] <= 0 or counts["flash_fwd_tc"]
            or counts["paged_decode"] <= 0
            or counts["flash_bwd_dq_f32"] <= 0
            or counts["flash_bwd_dkv_f32"] <= 0
            or counts["flash_bwd_dq_tc"] or counts["flash_bwd_dkv_tc"]):
        fail(f"crucible (a): launches {counts}")
    add(counts)
    del rig
    gc.collect()

    # (b) the slice at full width
    full = serving_config()
    big = crucible_model(dataclasses.replace(full, dtype=torch.float32),
                         "(b) serving")
    gang_cfg = dataclasses.replace(full, n_layers=CRUCIBLE_GANG_LAYERS)
    print(f"crucible (b) gangs: the 154M's widths at {gang_cfg.n_layers} "
          f"layers, {gang_cfg.dtype}", flush=True)
    with ShardedSaveTimer() as timer:
        sched, res, rig, counts, wall = crucible_soak(
            fa, pa, "(b)", CRUCIBLE_FULL_CYCLES, tmp / "b", model=big,
            gang_cfg=gang_cfg)
    crucible_gates("crucible (b)", sched, res, rig, CRUCIBLE_FULL_CYCLES)
    if (counts["flash_fwd_f32"] <= 0 or counts["flash_fwd_tc"] <= 0
            or counts["paged_decode"] <= 0
            or counts["flash_bwd_dq_tc"] <= 0
            or counts["flash_bwd_dkv_tc"] <= 0
            or counts["flash_bwd_dq_f32"] or counts["flash_bwd_dkv_f32"]):
        fail(f"crucible (b): launches {counts}")
    saved = sum(b for b, _ in timer.saves)
    mean_ms = (sum(ms for _, ms in timer.saves) / len(timer.saves)
               if timer.saves else float("nan"))
    print(f"crucible (b) 154M (serving f32; gangs bf16, "
          f"{gang_cfg.n_layers} layers): {wall:.1f} s, "
          f"{len(timer.saves)} generations saved, {saved / 2 ** 20:.1f} "
          f"MiB in all ({saved / 2 ** 20 / max(len(timer.saves), 1):.1f} "
          f"MiB each), mean save {mean_ms:.0f} ms; {len(timer.restores)} "
          f"restores (step, ms) "
          f"{[(s, round(ms)) for s, ms in timer.restores]}; "
          f"step_deadline_s {rig.step_deadline_s}, hang_stall_s "
          f"{rig.hang_stall_s}; burn alerts {rig.burn.alerts_total}",
          flush=True)
    if not timer.saves or not timer.restores:
        fail("crucible (b): no generation saved or restored")
    add(counts)
    del rig, big
    gc.collect()

    # (c) determinism: the spec-fleet schedule twice, then its repro
    def spec_schedule():
        return Schedule(seed=11, cycles=14, events=[
            FaultEvent(id="warm-burst", kind="burst", at_cycle=1, n=6,
                       prompt_seed=31),
            FaultEvent(id="mid-burst", kind="burst", at_cycle=4, n=6,
                       prompt_seed=47),
            FaultEvent(id="decode-kill", kind="replica_kill", at_cycle=5,
                       replica_glob="d*"),
            FaultEvent(id="kv-squeeze", kind="kv_exhaust", at_cycle=6,
                       heal_after=12),
            FaultEvent(id="tail-burst", kind="burst", at_cycle=8, n=6,
                       prompt_seed=59)])

    spec_kw = dict(model=small, device="cuda", draft_source="ngram",
                   draft_len=3)
    records = []
    for i in range(2):
        sched = spec_schedule()
        zero_counts(fa)
        pa.launches = 0
        res, rig = cru.run_soak(sched, tmp / f"c{i}", **spec_kw)
        counts = {**flash_routes(fa), "paged_decode": pa.launches,
                  "flash_fwd": fa.launches}
        add(counts)
        bad = [m for _, v in res.violations for m in v]
        if bad or res.finished != res.submitted or res.submitted != 18:
            fail(f"crucible (c) run {i}: {res.finished}/{res.submitted} "
                 f"finished, violations {bad[:8]}")
        records.append(crucible_record(sched, rig))
    same = {k: records[0][k] == records[1][k] for k in records[0]}
    print(f"crucible (c) spec fleet (seed 11, 14 cycles, n-gram) twice: "
          f"equal {same}; fired {records[0]['fired']}; "
          f"{len(records[0]['tokens'])} token arrays, injections "
          f"{ {k: len(v) for k, v in records[0]['plans'].items()} }",
          flush=True)
    if not all(same.values()):
        fail(f"crucible (c): the two runs parted: {same}")
    repro = cru.write_repro(tmp / "c-repro.json", sched, res)
    res2, rig2 = cru.replay(repro, tmp / "c-replay", **spec_kw)
    replayed = [(e.id, e.fired_cycle) for e in rig2.schedule.events]
    original = [(e.id, e.fired_cycle) for e in sched.events]
    print(f"crucible (c) repro replayed: fired {replayed} (original "
          f"{original}), violations {len(res2.violations)}", flush=True)
    if replayed != original or res2.violations:
        fail("crucible (c): the replay fired apart from the original")
    del rig, rig2
    gc.collect()
    print(f"crucible phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return routes, f32_routes


#: the sp phase: two worker processes on the one card, a gloo group
#: (NCCL refuses two ranks on one device), SP_STEPS steps of the 154M
SP_WORLD = 2
SP_STEPS = 3
#: seconds the sp workers may take, start to join; each collective's
#: own timeout (the rendezvous contract's barrier timeout) is shorter
SP_TIMEOUT_S = 420
SP_BARRIER_S = 180
#: sp losses against phase_train's single-device losses of the same
#: weights and batches, bf16: the ring merges its hops in f32 and rounds
#: p per hop against another running max, and the gradients are summed
#: over the two ranks in f32 before their bf16 rounding; AdamW's early
#: steps are near lr * sign(g), so a gradient entry near zero may take
#: the other sign.  Same-path reruns part by a few thousandths
#: (RESUME_TOL); held at under 1% of losses 5 to 11
SP_LOSS_TOL = 5e-2
#: the f32 card steps over the mesh against one CPU process, gradients
#: relative to each tensor's largest entry (summation order only)
SP_GRAD_TOL = 1e-4


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def kernel_counts(fa) -> dict:
    """K1 (normalized and block entry), K3 and K4 launches by route."""
    return {"fwd_tc": fa.tc_launches, "fwd_f32": fa.launches - fa.tc_launches,
            "block_tc": fa.block_tc_launches,
            "block_f32": fa.block_launches - fa.block_tc_launches,
            "dq_tc": fa.dq_tc_launches,
            "dq_f32": fa.dq_launches - fa.dq_tc_launches,
            "dkv_tc": fa.dkv_tc_launches,
            "dkv_f32": fa.dkv_launches - fa.dkv_tc_launches}


def profiled_step(step, params, opt, batch):
    """One train step under torch.profiler: (params, opt, loss, wall ms,
    device ms: the summed time of every kernel and copy it ran)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        loss = float(loss)
        wall = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages())
    return params, opt, loss, wall, (dev_us / 1e3 if dev_us > 0 else None)


def sp_worker(rank: int, world: int, port: int, job_path: str,
              out_dir: str) -> None:
    """One rank of the sp phase, on the card: the group from the
    rendezvous contract (gloo), then (a) the f32 small ring step, (d)
    the f32 small dp step, (b) SP_STEPS steps of the 154M over sp=2 by
    ring, (c) one 154M Ulysses step.  Writes its results, or its
    traceback, under ``out_dir``."""
    import traceback

    import torch.distributed as dist
    out = Path(out_dir)
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from k8s_dra_driver_tpu_torch.models.transformer import (
            make_train_step)
        from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
        from k8s_dra_driver_tpu_torch.parallel import rendezvous
        from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        env = {"TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "TPU_WORKER_ID": str(rank), "TPU_NUM_WORKERS": str(world),
               "TPU_RENDEZVOUS_BARRIER_TIMEOUT_S": str(SP_BARRIER_S)}
        rendezvous.initialize(rendezvous.spec_from_env(env), backend="gloo")
        res = {"psum": rendezvous.gang_psum(float(rank + 1))}
        job = torch.load(job_path, weights_only=False)
        sp_mesh = make_mesh(MeshSpec(sp=world), device="cuda")
        dp_mesh = make_mesh(MeshSpec(dp=world), device="cuda")
        res["coords"] = sp_mesh.coords
        small = small_train_config()
        for key, mesh in (("a", sp_mesh), ("d", dp_mesh)):
            zero_counts(fa)
            loss, params, grads = small_step(small, "cuda", job["tokens"],
                                             job["seg"], mesh=mesh)
            res[key] = dict(loss=loss, params=params, grads=grads,
                            counts=kernel_counts(fa))

        cfg = serving_config()
        step, init_state = make_train_step(cfg, device="cuda", mesh=sp_mesh)
        params, opt = init_state(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.reset_peak_memory_stats()
        res["b"] = []
        for batch in job["batches"]:
            zero_counts(fa)
            params, opt, loss, wall, dev = profiled_step(step, params, opt,
                                                         batch)
            res["b"].append(dict(loss=loss, wall_ms=wall, device_ms=dev,
                                 counts=kernel_counts(fa)))
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del params, opt, step, init_state
        torch.cuda.empty_cache()

        step, init_state = make_train_step(
            dataclasses.replace(cfg, seq_parallel="ulysses"), device="cuda",
            mesh=sp_mesh)
        params, opt = init_state(torch.Generator(device="cuda").manual_seed(0))
        zero_counts(fa)
        params, opt, loss, wall, dev = profiled_step(step, params, opt,
                                                     job["batches"][0])
        res["c"] = dict(loss=loss, wall_ms=wall, device_ms=dev,
                        counts=kernel_counts(fa))
        torch.save(res, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def grad_errors(grads, want) -> float:
    """Largest gradient difference relative to each tensor's largest
    entry."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(grads, want))


def phase_sp_train(fa, record: dict) -> dict:
    """Context-parallel training on the card: SP_WORLD worker processes
    share the one card, stand their group up through the port's
    ``rendezvous.initialize`` (gloo: NCCL refuses two ranks on one
    device, so every exchange is staged through host memory), check
    ``gang_psum``, then run (a) an f32 2-layer ring step against one CPU
    process's step (plain versions) of the same weights and batch, (b)
    SP_STEPS steps of the 154M at full width over MeshSpec(sp=2) by ring
    on phase_train's weights and first batches, losses against
    phase_train's, K1-block/K3/K4 launches 8 a step on rank 0 and 16 on
    rank 1 on the tensor cores and no normalized K1, (c) one Ulysses
    step likewise (the normalized K1, K3, K4 8 a step on each rank), (d)
    the f32 small step over MeshSpec(dp=2) as (a).  Any failure, hang
    past SP_TIMEOUT_S or disagreement fails the run.  Returns the main
    path's launches summed over ranks (the ring steps of (b); the f32
    block route from (a))."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    small = small_train_config()
    tokens, seg = small_batch(small)
    # meanwhile, the one-process CPU step (a) and (d) are held to
    ranks, (cpu_loss, cpu_params, cpu_grads), took = run_workers(
        sp_worker, SP_WORLD, dict(tokens=tokens, seg=seg,
                                  batches=record["batches"][:SP_STEPS]),
        "sp", SP_TIMEOUT_S, lambda: small_step(small, "cpu", tokens, seg))
    print(f"sp gang: {SP_WORLD} worker processes on the one card, group "
          f"from rendezvous.initialize (backend gloo: NCCL refuses two "
          f"ranks on one device), gang_psum {[r['psum'] for r in ranks]} "
          f"(expected {SP_WORLD * (SP_WORLD + 1) / 2}); workers took "
          f"{took:.1f} s start to join", flush=True)

    layers = small.n_layers
    small_want = {
        # ring: rank 0 runs its diagonal hop, rank 1 both hops
        "a": [dict(block_f32=layers * (r + 1), dq_f32=layers * (r + 1),
                   dkv_f32=layers * (r + 1)) for r in range(SP_WORLD)],
        # dp: the single-device path, one normalized K1 a layer
        "d": [dict(fwd_f32=layers, dq_f32=layers, dkv_f32=layers)
              for _ in range(SP_WORLD)]}
    for key, label in (("a", "MeshSpec(sp=2) ring"),
                       ("d", "MeshSpec(dp=2, sp=1)")):
        for r, res in enumerate(ranks):
            got = res[key]
            loss_rel = abs(got["loss"] - cpu_loss) / abs(cpu_loss)
            gerr = grad_errors(got["grads"], cpu_grads)
            strict, noisy, n_noisy = step_param_errors(got["params"],
                                                       cpu_params, cpu_grads)
            counts = {k: v for k, v in got["counts"].items() if v}
            ok = (loss_rel <= STEP_LOSS_RTOL and gerr <= SP_GRAD_TOL
                  and strict <= STEP_PARAM_ATOL and noisy <= 2 * 3e-4
                  and counts == small_want[key][r])
            print(f"sp ({key}) f32 small step {label}, rank {r} on the card "
                  f"(kernels) vs one CPU process (plain): loss "
                  f"{got['loss']:.7f} vs {cpu_loss:.7f} (rel {loss_rel:.3g}, "
                  f"tol {STEP_LOSS_RTOL}); grads max rel {gerr:.3g} (tol "
                  f"{SP_GRAD_TOL}); params max|d| {strict:.3g} (tol "
                  f"{STEP_PARAM_ATOL}), {n_noisy} noise-band entries max|d| "
                  f"{noisy:.3g}; launches {counts} (expected "
                  f"{small_want[key][r]}) {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"sp ({key}) small step disagrees on rank {r}")

    ref = record["losses"]
    layers = serving_config().n_layers
    for r, res in enumerate(ranks):
        hops = r + 1
        want = dict(block_tc=layers * hops, dq_tc=layers * hops,
                    dkv_tc=layers * hops)
        for i, st in enumerate(res["b"]):
            counts = {k: v for k, v in st["counts"].items() if v}
            gap = abs(st["loss"] - ref[i])
            ok = gap <= SP_LOSS_TOL and counts == want
            print(f"sp (b) 154M B={TRAIN_B} T={TRAIN_T} bf16 MeshSpec(sp=2) "
                  f"ring, step {i + 1} rank {r}: loss {st['loss']:.5f} vs "
                  f"single-device {ref[i]:.5f} (|d| {gap:.3g}, tol "
                  f"{SP_LOSS_TOL}); wall {st['wall_ms']:.1f} ms, device "
                  f"{fmt(st['device_ms'])} ms (kernels and copies; two "
                  f"processes sharing one card, host-staged gloo exchange, "
                  f"under the profiler); launches {counts} (expected "
                  f"{want}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"sp (b) step {i + 1} disagrees on rank {r}")
        print(f"sp (b) rank {r}: peak device memory {res['peak_gb']:.2f} "
              f"GiB", flush=True)
        st = res["c"]
        counts = {k: v for k, v in st["counts"].items() if v}
        want = dict(fwd_tc=layers, dq_tc=layers, dkv_tc=layers)
        gap = abs(st["loss"] - ref[0])
        ok = gap <= SP_LOSS_TOL and counts == want
        print(f"sp (c) 154M Ulysses step 1 rank {r}: loss {st['loss']:.5f} vs "
              f"single-device {ref[0]:.5f} (|d| {gap:.3g}, tol "
              f"{SP_LOSS_TOL}); wall {st['wall_ms']:.1f} ms, device "
              f"{fmt(st['device_ms'])} ms (same setup); launches {counts} "
              f"(expected {want}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"sp (c) Ulysses step disagrees on rank {r}")
    total = {k: sum(st["counts"][k] for res in ranks for st in res["b"])
             for k in ranks[0]["b"][0]["counts"]}
    total["block_f32"] = sum(res["a"]["counts"]["block_f32"]
                             for res in ranks)
    return total


def zero_moe_counts(fa, gm) -> None:
    zero_counts(fa)
    for name in gm.launches:
        gm.launches[name] = 0
    gm.tc_launches = gm.dw_tc_launches = 0


def moe_counts(fa, gm) -> dict:
    return {**train_counts(fa), **gm.launches}


def moe_step_launches(cfg, steps: int) -> dict:
    """Exact launches of ``steps`` gmm train steps: per layer K5 twice
    forward and twice for dx, K6 twice (dw of w_in and w_out), K1, K3
    and K4 once."""
    n = cfg.n_layers * steps
    return {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "gmm": 4 * n, "gmm_dw": 2 * n}


def phase_moe_train_small(fa, gm) -> dict:
    """One f32 AdamW step of a 2-layer, 4-expert gmm config with both
    router aux losses on the card (K1, K3-K6) and on the CPU (plain
    versions), from the same parameters and tokens; parameters
    compared by :func:`step_param_errors`.  Returns the card step's
    K3/K4 launches by route (all on the f32 route)."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        TransformerConfig, make_train_step, named_tensors)
    cfg = TransformerConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_head=64, d_ff=512, n_experts=4,
                            top_k=2, max_seq=256, dtype=torch.float32,
                            moe_dispatch="gmm", aux_loss_weight=0.01,
                            router_z_weight=0.001)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 256))
    results = {}
    for device in ("cuda", "cpu"):
        step, init_state = make_train_step(cfg, device=device)
        params, opt = init_state(torch.Generator().manual_seed(3))
        before = [t.detach().cpu().clone() for _, t in named_tensors(params)]
        zero_moe_counts(fa, gm)
        params, opt, loss = step(params, opt, tokens.astype(np.int32))
        leaves = named_tensors(params)
        missing = [n for n, t in leaves if t.grad is None]
        if missing:
            fail(f"MoE train step on {device}: no gradient for {missing}")
        after = [t.detach().cpu() for _, t in leaves]
        still = [n for (n, _), a, b in zip(leaves, after, before)
                 if torch.equal(a, b)]
        if still:
            fail(f"MoE train step on {device}: {still} did not move")
        if device == "cuda":
            routes = require_routes(fa, "train MoE f32 small step", 0,
                                    cfg.n_layers)
            routes.update(require_gmm_routes(
                gm, "train MoE f32 small step", 0, 4 * cfg.n_layers, 0,
                2 * cfg.n_layers))
        results[device] = (float(loss), after,
                           [t.grad.detach().cpu() for _, t in leaves],
                           moe_counts(fa, gm), [n for n, _ in leaves])
    (l_c, p_c, _, counts, names), (l_h, p_h, g_h, _, _) = (results["cuda"],
                                                          results["cpu"])
    want = moe_step_launches(cfg, 1)
    if counts != want:
        fail(f"small MoE step launched {counts}, expected {want}")
    loss_rel = abs(l_c - l_h) / abs(l_h)
    strict, noisy, n_noisy = step_param_errors(p_c, p_h, g_h)
    ok = (loss_rel <= STEP_LOSS_RTOL and strict <= STEP_PARAM_ATOL
          and noisy <= 2 * 3e-4)
    print(f"train MoE f32 small step (E=4 top_k=2 gmm, aux on), card "
          f"(kernels) vs CPU (plain): loss {l_c:.7f} vs {l_h:.7f} (rel "
          f"{loss_rel:.3g}, tol {STEP_LOSS_RTOL}); params max|d| "
          f"{strict:.3g} (tol {STEP_PARAM_ATOL}), {n_noisy} noise-band "
          f"entries max|d| {noisy:.3g} (tol 6e-4); all {len(names)} "
          f"tensors moved, router included; launches {counts} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the card's f32 MoE train step disagrees with the CPU's")
    return routes


def map_params(params, fn):
    """The parameter tree (a dict with a ``layers`` list of dicts) with
    ``fn`` applied to every tensor."""
    return {k: ([{n: fn(t) for n, t in layer.items()} for layer in v]
                if k == "layers" else fn(v)) for k, v in params.items()}


def phase_moe_train(fa, gm, tmp: Path, record: dict) -> dict:
    """moe_heavy at full width with gmm dispatch: TRAIN_STEPS AdamW
    steps of MOE_B x MOE_T tokens from a token file through
    ``BatchLoader``, load-balance loss weight MOE_AUX_WEIGHT, with the
    kernel counters zeroed just before and read just after; then three
    steps again from the same seed (bitwise the same losses and
    parameters: no step is order-dependent); then one bf16 forward of
    the initial parameters under dense dispatch against gmm.  Returns
    the steps' launches; ``record`` gets the losses and the first
    SP_STEPS batches, which the mesh phase trains again over ep=2."""
    from k8s_dra_driver_tpu_torch.models.data import (BatchLoader,
                                                      load_token_file,
                                                      write_token_file)
    from k8s_dra_driver_tpu_torch.models.transformer import (
        forward, make_train_step, named_tensors)
    cfg = moe_heavy_config(aux_loss_weight=MOE_AUX_WEIGHT)
    motif = np.random.default_rng(1).integers(0, cfg.vocab, 32)
    corpus = np.tile(motif, 2 * MOE_B * MOE_T // 32)
    path = write_token_file(corpus, tmp / "moe_corpus.bin", cfg.vocab)

    def loader():
        return BatchLoader(load_token_file(path, cfg.vocab), batch=MOE_B,
                           seq_len=MOE_T, seed=0)

    step, init_state = make_train_step(cfg, device="cuda")
    params, opt = init_state(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for _, t in named_tensors(params))
    initial = map_params(params, lambda t: t.detach().clone())
    data = loader()
    first = None
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_moe_counts(fa, gm)
    record["batches"] = []
    for _ in range(TRAIN_STEPS):
        batch = next(data)
        first = batch if first is None else first
        if len(record["batches"]) < SP_STEPS:
            record["batches"].append(batch)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))          # waits for the step
        walls.append(time.perf_counter() - t0)
    record["losses"] = losses
    counts = moe_counts(fa, gm)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = 1e3 * sum(walls[1:]) / (len(walls) - 1)
    want = moe_step_launches(cfg, TRAIN_STEPS)
    print(f"train moe_heavy ({n_params} parameters, E={cfg.n_experts} "
          f"top_k={cfg.top_k} gmm, aux weight {MOE_AUX_WEIGHT}) "
          f"B={MOE_B} T={MOE_T} bf16: losses "
          f"{[round(x, 5) for x in losses]}; step wall ms "
          f"{[round(1e3 * w, 1) for w in walls]} (mean of steps 2-"
          f"{TRAIN_STEPS}: {step_ms:.1f} ms = "
          f"{MOE_B * MOE_T / (step_ms / 1e3):.0f} tokens/s); peak device "
          f"memory {peak_gb:.2f} GiB; kernel launches {counts} (expected "
          f"{want})", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"non-finite MoE training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"MoE training loss did not fall: {losses}")
    if counts != want:
        fail(f"MoE training launched {counts}, expected {want}")
    counts.update(require_routes(fa, "train moe_heavy",
                                 cfg.n_layers * TRAIN_STEPS, 0))
    counts.update(require_gmm_routes(gm, "train moe_heavy",
                                     want["gmm"], 0, want["gmm_dw"], 0))

    # the same three steps again from the same seed
    params2, opt2 = init_state(torch.Generator(device="cuda").manual_seed(0))
    data2 = loader()
    again = []
    for _ in range(3):
        params2, opt2, loss = step(params2, opt2, next(data2))
        again.append(float(loss))
    ref = [t.detach().clone() for _, t in named_tensors(params2)]
    del params2, opt2
    params3, opt3 = init_state(torch.Generator(device="cuda").manual_seed(0))
    data3 = loader()
    for _ in range(3):
        params3, opt3, _ = step(params3, opt3, next(data3))
    same = all(torch.equal(a, t.detach())
               for a, (_, t) in zip(ref, named_tensors(params3)))
    same_losses = again == losses[:3]
    print(f"train moe_heavy repeat: three steps from the same seed, losses "
          f"{[round(x, 5) for x in again]} equal to the run's first three "
          f"{same_losses}; parameters of two repeats bitwise equal {same}",
          flush=True)
    del params3, opt3, ref, params, opt
    if not (same and same_losses):
        fail("the MoE train step is not deterministic")

    # gmm against dense dispatch on the initial parameters
    toks = torch.as_tensor(first[:2], device="cuda")
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    as_f32 = map_params(initial, lambda t: t.float())
    gaps = {}
    with torch.no_grad():
        for label, c, p in (("f32", f32, as_f32), ("bf16", cfg, initial)):
            got = forward(p, toks, c).float()
            dense = forward(p, toks, dataclasses.replace(
                c, moe_dispatch="dense")).float()
            if not torch.isfinite(got).all():
                fail(f"non-finite gmm logits ({label})")
            gaps[label] = ((got - dense).abs().max().item(),
                           max(1.0, dense.abs().max().item()))
        ties = router_ties(initial, toks, cfg)
    torch.cuda.synchronize()
    (err, scale), (err_bf, _) = gaps["f32"], gaps["bf16"]
    ok = err <= DISPATCH_TOL * scale
    print(f"moe_heavy forward B=2 T={MOE_T}, gmm (K5) vs dense dispatch "
          f"(no kernel in the MLP), initial weights in f32: logits max|d| "
          f"{err:.4g} (tol {DISPATCH_TOL} x max(1, max|dense| "
          f"{scale:.3g})) {'ok' if ok else 'FAIL'}; in bf16 max|d| "
          f"{err_bf:.4g} with {ties} of {toks.numel()} tokens tied at the "
          f"k-th gate in layer 0 (not held: dense mixes every tied "
          f"expert, gmm exactly top_k)", flush=True)
    if not ok:
        fail("gmm dispatch disagrees with dense dispatch at moe_heavy")
    return counts


def router_ties(params, toks, cfg) -> int:
    """Tokens whose layer-0 router keeps more than top_k experts (a tie
    at the k-th gate)."""
    from k8s_dra_driver_tpu_torch.models import transformer as tt
    layer = params["layers"][0]
    x = tt.take_rows(params["embed"], toks, cfg.dtype)
    x = x + tt._attention(tt.rms_norm(x, layer["ln1"]), layer, cfg)
    gates = tt._router_gates(tt.rms_norm(x, layer["ln2"]), layer, cfg)[0]
    return int(((gates > 0).sum(-1) > cfg.top_k).sum())


def phase_moe_serving(fa, pa, gm) -> dict:
    """One contiguous ServingEngine drain of the s8_r24 traffic at
    moe_heavy's widths (vocab 1024; served with dense dispatch, K1 for
    prefill), every greedy stream held to a teacher-forced forward
    under gmm dispatch (K5).  In f32: in bf16 the router's logits tie
    at the k-th gate for about 1% of tokens, where the serving dispatch
    (dense: every tied expert) and the training one (gmm: exactly
    top_k) of the JAX package part by whole logits, so a bf16 stream
    cannot be held to a gmm forward.  Returns the drain's launches."""
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.models.transformer import init_params
    cfg = moe_heavy_config(dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")
    reqs = s8_r24(cfg.vocab)
    zero_moe_counts(fa, gm)
    done, counts, _, _ = drain(ServingEngine, params, cfg, reqs, fa, pa,
                            "moe_heavy f32 contiguous", top_k=50)
    counts = {**counts, **{k: v for k, v in gm.launches.items()}}
    if counts["flash_fwd"] <= 0:
        fail("the MoE drain launched no flash kernel")
    gm.launches["gmm"] = gm.tc_launches = 0
    worst = teacher_forced(params, cfg, done, reqs)
    print(f"teacher-forced (moe_heavy f32, forward under gmm dispatch, K5 "
          f"launched {gm.launches['gmm']} times): worst gap {worst:.4f} "
          f"<= {TF_MARGIN}", flush=True)
    if gm.launches["gmm"] <= 0:
        fail("the MoE teacher-forced check launched no gmm kernel")
    require_gmm_routes(gm, "moe_heavy f32 teacher-forced check", 0,
                       gm.launches["gmm"], 0, 0)
    return counts


#: the mesh phase: worker processes on the one card (gloo), part (a)'s
#: ep x tp step on MESH_MOE_WORLD of them, (a)'s tp step and (b)-(d) on
#: SP_WORLD; the seconds each group may take, start to join
MESH_MOE_WORLD = 4
MESH_TIMEOUT_S = 480


def small_moe_config():
    """small_train_config made MoE with gmm dispatch (4 experts, top 2),
    the f32 config of the ep x tp card-vs-CPU step."""
    return dataclasses.replace(small_train_config(), n_experts=4, top_k=2,
                               moe_dispatch="gmm")


def mesh_counts(fa, gm) -> dict:
    """K1, K3, K4 (normalized entry), K5 and K6 launches by route, the
    nonzero ones."""
    routes = {**flash_routes(fa), "gmm_tc": gm.tc_launches,
              "gmm_f32": gm.launches["gmm"] - gm.tc_launches,
              "gmm_dw_tc": gm.dw_tc_launches,
              "gmm_dw_f32": gm.launches["gmm_dw"] - gm.dw_tc_launches}
    return {k: v for k, v in routes.items() if v}


def mesh_small_step(cfg, tokens, seg, mesh):
    """small_step over ``mesh``: one AdamW step of ``cfg`` from generator
    seed 3 on this rank's blocks; (loss, every parameter after the step
    and every summed gradient, gathered whole, on the host)."""
    from k8s_dra_driver_tpu_torch.models.transformer import (
        gather_params, grad_tree, make_train_step, named_tensors)
    step, init_state = make_train_step(cfg, device="cuda", mesh=mesh)
    params, opt = init_state(torch.Generator().manual_seed(3))
    params, opt, loss = step(params, opt, tokens, seg)
    grads = gather_params(grad_tree(params), cfg, mesh)
    whole = gather_params(params, cfg, mesh)
    return (float(loss), [t.cpu() for _, t in named_tensors(whole)],
            [g.cpu() for _, g in named_tensors(grads)])


def mesh_worker(rank: int, world: int, port: int, job_path: str,
                out_dir: str) -> None:
    """One rank of the mesh phase, on the card: the group from the
    rendezvous contract (gloo), then the job's parts in turn — "a_moe"
    (the f32 small MoE step over ep=2 x tp=2), "a_tp" (the f32 small
    step over tp=2), "b" (the 154M over tp=2), "c" (moe_heavy over ep=2)
    and "d" (the 154M over pp=2).  Writes its results, or its
    traceback, under ``out_dir``."""
    import traceback

    import torch.distributed as dist
    out = Path(out_dir)
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from k8s_dra_driver_tpu_torch.models import transformer as tt
        from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
        from k8s_dra_driver_tpu_torch.ops import gmm as gm
        from k8s_dra_driver_tpu_torch.parallel import rendezvous
        from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        env = {"TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "TPU_WORKER_ID": str(rank), "TPU_NUM_WORKERS": str(world),
               "TPU_RENDEZVOUS_BARRIER_TIMEOUT_S": str(SP_BARRIER_S)}
        rendezvous.initialize(rendezvous.spec_from_env(env), backend="gloo")
        res = {"psum": rendezvous.gang_psum(float(rank + 1))}
        job = torch.load(job_path, weights_only=False)
        for part in job["parts"]:
            if part in ("a_moe", "a_tp"):
                cfg = (small_moe_config() if part == "a_moe"
                       else small_train_config())
                mesh = make_mesh(MeshSpec(ep=2, tp=2) if part == "a_moe"
                                 else MeshSpec(tp=2), device="cuda")
                zero_moe_counts(fa, gm)
                loss, params, grads = mesh_small_step(
                    cfg, job["tokens"], job["seg"], mesh)
                res[part] = dict(loss=loss, params=params, grads=grads,
                                 counts=mesh_counts(fa, gm),
                                 coords=mesh.coords)
                continue
            if part == "c":
                cfg = moe_heavy_config(aux_loss_weight=MOE_AUX_WEIGHT)
                spec, batches = MeshSpec(ep=2), job["moe_batches"]
            else:
                cfg = serving_config()
                if part == "d":
                    cfg = dataclasses.replace(cfg, pp_stages=2)
                spec = MeshSpec(tp=2) if part == "b" else MeshSpec(pp=2)
                batches = job["batches"]
            mesh = make_mesh(spec, device="cuda")
            step, init_state = tt.make_train_step(cfg, device="cuda",
                                                  mesh=mesh)
            params, opt = init_state(
                torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.reset_peak_memory_stats()
            steps, routed = [], []
            plain = tt._gmm_dispatch_combine

            def counted(xf, gate_vals, expert_ids, w_in, w_out, e, bm):
                # this rank's routed rows: its own experts', and the
                # dead group's (the last of the e groups)
                routed.append((int((expert_ids < e - 1).sum()),
                               int((expert_ids == e - 1).sum())))
                return plain(xf, gate_vals, expert_ids, w_in, w_out, e, bm)

            for i, batch in enumerate(batches):
                tt._gmm_dispatch_combine = counted if i == 0 else plain
                zero_moe_counts(fa, gm)
                params, opt, loss, wall, dev = profiled_step(
                    step, params, opt, batch)
                steps.append(dict(loss=loss, wall_ms=wall, device_ms=dev,
                                  counts=mesh_counts(fa, gm)))
            tt._gmm_dispatch_combine = plain
            res[part] = dict(
                steps=steps, coords=mesh.coords, routed=routed,
                peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
            del params, opt, step, init_state
            torch.cuda.empty_cache()
        torch.save(res, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_workers(target, world: int, job: dict, label: str, timeout_s: float,
                cpu_work=None):
    """``world`` processes of ``target(rank, world, port, job_path,
    out_dir)`` on the card running ``job``; while they run,
    ``cpu_work()`` (the CPU references) runs here.  Returns (the ranks'
    results, cpu_work's result, seconds start to join); any failure, a
    hang past ``timeout_s`` or a wrong ``gang_psum`` fails the run."""
    import multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        job_path = Path(tmp) / "job.pt"
        torch.save(job, job_path)
        ctx = mp.get_context("spawn")
        port = free_port()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=target,
                             args=(r, world, port, str(job_path), tmp))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        extra = cpu_work() if cpu_work is not None else None
        deadline = time.monotonic() + timeout_s
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(30)
        took = time.perf_counter() - t0
        errs = {r: (Path(tmp) / f"rank{r}.err").read_text()
                for r in range(world)
                if (Path(tmp) / f"rank{r}.err").exists()}
        codes = [proc.exitcode for proc in procs]
        if hung or errs or any(codes):
            fail(f"{label} workers failed: hung {hung} (timeout "
                 f"{timeout_s} s), exit codes {codes}\n"
                 + "\n".join(f"rank {r}:\n{e}" for r, e in errs.items()))
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(world)]
    want = world * (world + 1) / 2
    if [r["psum"] for r in ranks] != [want] * world:
        fail(f"{label}: gang_psum {[r['psum'] for r in ranks]}")
    return ranks, extra, took


def phase_mesh_train(fa, gm, record: dict, moe_record: dict) -> dict:
    """Tensor, expert and pipeline parallelism on the card: worker
    processes share the one card and stand their group up through
    ``rendezvous.initialize`` (gloo: NCCL refuses two ranks on one
    device, so every collective is staged through host memory).

    (a) f32 2-layer steps against one CPU process's single-device step
    (plain versions) of the same weights and batch: small_train_config
    over MeshSpec(tp=2), and made MoE with gmm dispatch over
    MeshSpec(ep=2, tp=2) on four ranks; each rank's loss, its gradients
    and its parameters after the step, gathered whole, at phase_sp_train's
    tolerances, and exact f32-route launches.  (b) SP_STEPS steps of the
    154M bf16 over MeshSpec(tp=2) on phase_train's weights and batches,
    losses against phase_train's, K1/K3/K4 8 a step on each rank on the
    tensor cores (8 of the 16 heads).  (c) moe_heavy bf16 gmm over
    MeshSpec(ep=2) against phase_moe_train's losses, each rank's step
    the launches of moe_step_launches(cfg, 1) on the tensor cores (K5/K6
    over its 8 experts and the dead group), and each rank's live and
    dead-group rows.  (d) the 154M bf16 over MeshSpec(pp=2): GPipe, 4
    layers a stage, 2 S = 4 microbatches, the bubble ticks skipped, so
    K1/K3/K4 launch 4 x 4 = 16 times a step on each stage.  Returns the
    launches summed over ranks by route."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    card = card_line()
    small = small_train_config()
    tokens, seg = small_batch(small)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def small_refs():
        return {"a_tp": small_step(small, "cpu", tokens, seg),
                "a_moe": small_step(small_moe_config(), "cpu", tokens, seg)}

    moe_ranks, cpu, took_a = run_workers(
        mesh_worker, MESH_MOE_WORLD,
        dict(parts=["a_moe"], tokens=tokens, seg=seg), "mesh (a) ep x tp",
        MESH_TIMEOUT_S, small_refs)
    ranks, _, took = run_workers(
        mesh_worker, SP_WORLD,
        dict(parts=["a_tp", "b", "c", "d"], tokens=tokens, seg=seg,
             batches=record["batches"][:SP_STEPS],
             moe_batches=moe_record["batches"][:SP_STEPS]),
        "mesh (a) tp, (b)-(d)", MESH_TIMEOUT_S)
    print(f"mesh gang: {MESH_MOE_WORLD} then {SP_WORLD} worker processes "
          f"on the one card, groups from rendezvous.initialize (gloo), "
          f"took {took_a:.1f} s and {took:.1f} s start to join; {card}",
          flush=True)

    layers = small.n_layers
    f32_flash = {"flash_fwd_f32": layers, "flash_bwd_dq_f32": layers,
                 "flash_bwd_dkv_f32": layers}
    for part, label, per_rank, want in (
            ("a_tp", "MeshSpec(tp=2)", ranks, f32_flash),
            ("a_moe", "MeshSpec(ep=2, tp=2) MoE gmm", moe_ranks,
             {**f32_flash, "gmm_f32": 4 * layers, "gmm_dw_f32": 2 * layers})):
        cpu_loss, cpu_params, cpu_grads = cpu[part]
        for r, res in enumerate(per_rank):
            got = res[part]
            loss_rel = abs(got["loss"] - cpu_loss) / abs(cpu_loss)
            gerr = grad_errors(got["grads"], cpu_grads)
            strict, noisy, n_noisy = step_param_errors(got["params"],
                                                       cpu_params, cpu_grads)
            ok = (loss_rel <= STEP_LOSS_RTOL and gerr <= SP_GRAD_TOL
                  and strict <= STEP_PARAM_ATOL and noisy <= 2 * 3e-4
                  and got["counts"] == want)
            print(f"mesh (a) f32 small step {label}, rank {r} "
                  f"{got['coords']} on the card (kernels) vs one CPU process "
                  f"(plain): loss {got['loss']:.7f} vs {cpu_loss:.7f} (rel "
                  f"{loss_rel:.3g}, tol {STEP_LOSS_RTOL}); gathered grads "
                  f"max rel {gerr:.3g} (tol {SP_GRAD_TOL}); gathered params "
                  f"max|d| {strict:.3g} (tol {STEP_PARAM_ATOL}), {n_noisy} "
                  f"noise-band entries max|d| {noisy:.3g}; launches "
                  f"{got['counts']} (expected {want}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"mesh (a) {label} disagrees on rank {r}")
            add(got["counts"])

    n = serving_config().n_layers
    heavy = moe_heavy_config()
    moe_want = moe_step_launches(heavy, 1)
    for part, label, ref, want in (
            ("b", "154M bf16 MeshSpec(tp=2), 8 of 16 heads a rank",
             record["losses"], {"flash_fwd_tc": n, "flash_bwd_dq_tc": n,
                                "flash_bwd_dkv_tc": n}),
            ("c", "moe_heavy bf16 gmm MeshSpec(ep=2), 8 experts a rank",
             moe_record["losses"],
             {"flash_fwd_tc": moe_want["flash_fwd"],
              "flash_bwd_dq_tc": moe_want["flash_bwd_dq"],
              "flash_bwd_dkv_tc": moe_want["flash_bwd_dkv"],
              "gmm_tc": moe_want["gmm"], "gmm_dw_tc": moe_want["gmm_dw"]}),
            ("d", "154M bf16 MeshSpec(pp=2) GPipe, 4 layers a stage, 4 "
             "microbatches", record["losses"],
             {"flash_fwd_tc": 16, "flash_bwd_dq_tc": 16,
              "flash_bwd_dkv_tc": 16})):
        for r, res in enumerate(ranks):
            got = res[part]
            for i, st in enumerate(got["steps"]):
                gap = abs(st["loss"] - ref[i])
                ok = gap <= SP_LOSS_TOL and st["counts"] == want
                print(f"mesh ({part}) {label}, step {i + 1} rank {r} "
                      f"{got['coords']}: loss {st['loss']:.5f} vs "
                      f"single-device {ref[i]:.5f} (|d| {gap:.3g}, tol "
                      f"{SP_LOSS_TOL}); wall {st['wall_ms']:.1f} ms, device "
                      f"{fmt(st['device_ms'])} ms (kernels and copies; two "
                      f"processes sharing one card, host-staged gloo "
                      f"collectives, under the profiler); launches "
                      f"{st['counts']} (expected {want}) "
                      f"{'ok' if ok else 'FAIL'}; {card}", flush=True)
                if not ok:
                    fail(f"mesh ({part}) step {i + 1} disagrees on rank {r}")
                add(st["counts"])
            if part == "c":
                live = sum(a for a, _ in got["routed"])
                dead = sum(b for _, b in got["routed"])
                print(f"mesh (c) rank {r}: step 1 routed {live} rows to its "
                      f"own experts and {dead} to the dead group over "
                      f"{len(got['routed'])} layers ({live + dead} gathered "
                      f"token slots)", flush=True)
                if live + dead != len(got["routed"]) * MOE_B * MOE_T \
                        * heavy.top_k:
                    fail(f"mesh (c): rank {r} routed {live} + {dead} rows")
            print(f"mesh ({part}) rank {r}: peak device memory "
                  f"{got['peak_gb']:.2f} GiB", flush=True)
    return total


MEASURE_SIM = dict(seed=7, cycles=20, ab_cycles=70)
# K7's tuned shapes: (kind, G, M, K, N, dtype, candidates); the 154M
# unembedding at 8 slots and moe_heavy's up-projection (x shared by the
# experts, f32 as the int8 MoE drain runs it; ring 3 there is a plan the
# kernel refuses, recorded as an error run)
MEASURE_TUNE = (
    ("K7a", 1, 8, 1024, 32000, torch.bfloat16,
     [{"k_chunk": c, "ring": r} for c in (1024, 512, 256) for r in (3, 2)]),
    ("K7b", 16, 8, 512, 4096, torch.float32,
     [{"k_chunk": c, "ring": 2} for c in (512, 256, 128)]
     + [{"k_chunk": 512, "ring": 3}]),
)
# weight copies a tuning chain cycles through, so that every call finds
# its weight outside the 50 MB L2, as a decode step does
MEASURE_WEIGHT_COPIES = 4
MEASURE_TUNE_ITERS = 32


def start_sim_probe() -> tuple[subprocess.Popen, Path]:
    """``python -m k8s_dra_driver_tpu_torch.sim.probe`` in a process of
    its own, writing under a fresh temporary directory: the simulator
    runs on the host (no tensor, no device), so it runs beside the
    card's phases and ``phase_measure`` collects it.  The process is
    killed and the directory removed when this script exits, whatever
    the exit."""
    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-sim-"))
    workdir = tmp / "sim"
    args = [sys.executable, "-m", "k8s_dra_driver_tpu_torch.sim.probe",
            "--seed", str(MEASURE_SIM["seed"]),
            "--cycles", str(MEASURE_SIM["cycles"]),
            "--ab-cycles", str(MEASURE_SIM["ab_cycles"]),
            "--workdir", str(workdir)]
    with open(tmp / "sim_probe.err", "w") as err:
        proc = subprocess.Popen(args, cwd=root, stdout=subprocess.PIPE,
                                stderr=err, text=True)

    def stop() -> None:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return proc, workdir


def tune_k7(qm, at, col, tuner, card: str) -> list:
    """``tuner.tune`` over MEASURE_TUNE: each candidate plan timed by the
    differential-median harness (``measure_chain``: a chain of calls
    captured as one CUDA graph, each call through the next of
    MEASURE_WEIGHT_COPIES weights and feeding a scalar of its output
    into the next call's x) and valid only when its output is within
    INT8_TOL of the plain version and the harness found no artifact.
    Returns [(kind, G, M, K, N, dtype, best plan, x, weight, plain
    output, call)]."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    tuned = []
    for kind, g, m, k, n, dtype, cands in MEASURE_TUNE:
        copies = []
        for _ in range(MEASURE_WEIGHT_COPIES):
            w = torch.randn((g, k, n), generator=gen, device=dev) * k ** -0.5
            copies.append(qm.quantize(w, (1,)))
            del w
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        batched = kind == "K7b"

        def call(x2, qt, params, batched=batched, g=g, m=m, k=k):
            if batched:        # btd,edf->btef: x shared, stride 0 over E
                return qm.int8_bmm(x2[None].expand(g, m, k), qt.q,
                                   qt.scale, **params)
            return qm.int8_matmul(x2, qt.q[0], qt.scale[0], **params)

        def plain(x2, qt, batched=batched, g=g, m=m, k=k):
            if batched:
                return qm.int8_bmm_reference(x2[None].expand(g, m, k),
                                             qt.q, qt.scale)
            return qm.int8_matmul_reference(x2, qt.q[0], qt.scale[0])

        want = plain(x, copies[0])
        es = torch.tensor([], dtype=dtype).element_size()
        bound_ms, _ = int8_bound(g, m, k, n, es, m, H100_BF16_FLOPS
                                 if dtype == torch.bfloat16
                                 else H100_F32_FLOPS)
        # the weight's int8 bytes at the harness's generous memory
        # ceiling: a reading below it is an artifact
        floor_s = g * k * n / (col._PEAK_HBM_GBPS_CEILING * 1e9)
        checks = {}

        def measure(params, x=x, copies=copies, want=want, call=call,
                    floor_s=floor_s, checks=checks, dtype=dtype):
            got = call(x, copies[0], params)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            agrees = err <= INT8_TOL[dtype] * scale
            checks[json.dumps(params, sort_keys=True)] = err

            def body(acc, n_calls):
                for i in range(n_calls):
                    y = call(acc, copies[i % len(copies)], params)
                    # a scalar of the output into the next x keeps the
                    # calls dependent, whatever their shapes
                    acc = acc + (y.float().sum() * 1e-7).to(acc.dtype)
                return acc.float().sum()

            def make(n_calls):
                # the chain is one CUDA graph, as the reference's is one
                # compiled program: a replay times the device, not the
                # host's enqueue of n_calls launches; each call copies
                # its fresh input into the graph's x first
                static_x = x.clone()
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    body(static_x, 1)           # allocations, the plan
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    total = body(static_x, n_calls)

                def chain(arg):
                    static_x.copy_(arg)
                    graph.replay()
                    return total
                return chain

            seconds, valid = col.measure_chain(make, x, MEASURE_TUNE_ITERS,
                                               floor_s)
            return seconds, valid and agrees

        key = at.shape_key(g=g, m=m, k=k, n=n)
        name = "int8_bmm" if batched else "int8_matmul"
        default = qm.int8_plan(g, m, k, n, dtype)
        best = tuner.tune(name, key, dtype, cands, measure)
        entry = tuner.table[at.table_key(name, key, dtype, at.backend_key())]
        for run in entry["runs"]:
            err = checks.get(json.dumps(run["params"], sort_keys=True))
            print(f"measure (a) tune {kind} {key} "
                  f"{str(dtype)[6:]} {run['params']}: "
                  + (f"error {run['error']}" if "error" in run else
                     f"chain_ms={run['ms']:.4f} valid={run['valid']} "
                     f"max|d|={err:.3g} (tol {INT8_TOL[dtype]})")
                  + f" [{card}]", flush=True)
        print(f"measure (a) tune {kind} best {best} (valid "
              f"{entry['valid']}, {entry['ms']:.4f} ms a chained call, the "
              f"fold-back included; int8_plan's "
              f"k_chunk {default.k_chunk} ring {default.ring}; bound "
              f"{bound_ms * 1e3:.2f} us; the kernel table's cold kernel ms "
              f"{'0.0280' if kind == 'K7a' else '0.0438'}) [{card}]",
              flush=True)
        if not entry["valid"]:
            fail(f"{kind}: no tuned candidate was valid")
        tuned.append((kind, g, m, k, n, dtype, best, x, copies[0], want,
                      call))
    return tuned


def measure_counts(fa, qm) -> dict:
    return {"flash_fwd": fa.launches, "flash_fwd_tc": fa.tc_launches,
            "flash_bwd_dq_tc": fa.dq_tc_launches,
            "flash_bwd_dkv_tc": fa.dkv_tc_launches,
            "int8_matmul": qm.launches["int8_matmul"],
            "int8_tc": qm.tc_launches}


def phase_measure(fa, qm, sim: subprocess.Popen, sim_dir: Path,
                  tmp: Path) -> dict:
    """The measurement utilities on the card.  (a) the autotuner:
    ``backend_key`` names the card; the checked-in H100 table holds no
    entries, so every K7 launch of the run took ``int8_plan``'s plan
    (picks by source, none measured); ``Autotuner.tune`` over K7a at
    the 154M unembedding and K7b at moe_heavy's up-projection (each
    candidate held to the plain version); the saved table pointed to
    by ``TPU_AUTOTUNE_TABLE``: the wrapper launches the tuned plan
    within tolerance; the default restored.  (b) the probes of
    ``ops/collectives.py`` at their defaults (the 154M for decode and
    serving), each ``valid``, K1, K3/K4 and K7 launches counted (these
    join the kernels line).  (c) ``utils/profiling.py``: a Chrome trace
    of one 154M generation step (prefill and one decode step) holding
    the ``annotate`` span and K1's kernel, and a device memory
    snapshot; then the fleet simulator's probe, which ran on the HOST
    in its own process beside the serving and training phases
    (``start_sim_probe``; the simulator touches no device): 1000
    replicas, no violation,
    every cycle survived, the minimized repro still starving, and a
    same-seed rerun of its soak here with an equal journal digest.
    Every line carries the card's name and power limit."""
    from k8s_dra_driver_tpu_torch.models import greedy_generate
    from k8s_dra_driver_tpu_torch.ops import autotune as at
    from k8s_dra_driver_tpu_torch.ops import collectives as col
    from k8s_dra_driver_tpu_torch.sim.fleet import SimConfig
    from k8s_dra_driver_tpu_torch.sim.rig import (default_sim_schedule,
                                                  run_sim_soak)
    from k8s_dra_driver_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    card = card_line()

    # (a) the autotuner and K7's plan
    backend = at.backend_key()
    want_backend = "gpu-" + re.sub(r"[^a-z0-9]+", "-",
                                   torch.cuda.get_device_name(0).lower()
                                   ).strip("-")
    if backend != want_backend:
        fail(f"backend_key {backend!r}, want {want_backend!r}")
    default = at.get_autotuner()
    if default.path != at.DEFAULT_TABLE_PATH or default.table:
        fail(f"the run's table is {default.path} with "
             f"{len(default.table)} entries: want the checked-in H100 "
             f"table, empty")
    print(f"measure (a) backend_key {backend}; table "
          f"{at.DEFAULT_TABLE_PATH.name}: 0 entries; K7 plan picks this "
          f"run by source: {default.picks} [{card}]", flush=True)
    if default.picks["measured"] or not default.picks["default"]:
        fail(f"K7's picks {default.picks}: want every one int8_plan's")
    tuner = at.Autotuner(tmp / "autotune_tuned.json")
    tuned = tune_k7(qm, at, col, tuner, card)
    table = tuner.save(meta={"card": card})
    old_env = os.environ.get(at.TABLE_ENV)
    os.environ[at.TABLE_ENV] = str(table)
    at.reset_autotuner()
    try:
        for kind, g, m, k, n, dtype, best, x, qt, want, call in tuned:
            plan = qm.pick_int8_tiles(g, m, k, n, dtype,
                                      batched=kind == "K7b")
            if (plan.k_chunk, plan.ring) != (best["k_chunk"], best["ring"]):
                fail(f"{kind}: the wrapper's plan {plan} is not the "
                     f"tuned {best}")
            before = dict(qm.launches)
            got = call(x, qt, {})
            torch.cuda.synchronize()
            name = "int8_bmm" if kind == "K7b" else "int8_matmul"
            if qm.launches[name] != before[name] + 1:
                fail(f"{kind}: the tuned call launched no kernel")
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            print(f"measure (a) {kind} through the tuned table: {plan}, "
                  f"max|d|={err:.3g} (tol {INT8_TOL[dtype]} x {scale:.3g}) "
                  f"[{card}]", flush=True)
            if err > INT8_TOL[dtype] * scale:
                fail(f"{kind} disagrees with its plain version on the "
                     f"tuned plan")
        if at.get_autotuner().picks["measured"] != len(tuned):
            fail(f"tuned picks {at.get_autotuner().picks}")
    finally:
        if old_env is None:
            os.environ.pop(at.TABLE_ENV, None)
        else:
            os.environ[at.TABLE_ENV] = old_env
        at.reset_autotuner()
    if qm.pick_int8_tiles(1, 8, 1024, 32000, torch.bfloat16) != \
            qm.int8_plan(1, 8, 1024, 32000, torch.bfloat16):
        fail("the default table was not restored")
    del tuned
    torch.cuda.empty_cache()

    # (b) the probes; their kernel launches join the main paths'
    start = measure_counts(fa, qm)

    def probe(label, fn, **kw):
        t0 = time.perf_counter()
        before = measure_counts(fa, qm)
        out = fn(**kw)
        after = measure_counts(fa, qm)
        delta = {k2: after[k2] - before[k2] for k2 in after
                 if after[k2] != before[k2]}
        print(f"measure (b) {label} ({time.perf_counter() - t0:.1f} s; "
              f"launches {delta}): {json.dumps(out)} [{card}]", flush=True)
        if not out["valid"]:
            fail(f"{label} is not valid")
        return out, delta

    _, d = probe("attention_probe", col.attention_probe)
    if d.get("flash_fwd_tc", 0) <= 0 or d.get("flash_fwd_tc") != \
            d.get("flash_fwd"):
        fail(f"attention_probe's K1 launches {d}: want all on the tensor "
             f"cores")
    _, d = probe("attention_grad_probe", col.attention_grad_probe)
    if min(d.get(k2, 0) for k2 in ("flash_fwd_tc", "flash_bwd_dq_tc",
                                   "flash_bwd_dkv_tc")) <= 0:
        fail(f"attention_grad_probe's K1/K3/K4 launches {d}")
    probe("matmul_tflops", col.matmul_tflops, dim=4096)
    for int8 in (False, True):
        out, d = probe(f"decode_probe{' int8' if int8 else ''}",
                       col.decode_probe, int8=int8)
        if out["implied_gbps"] >= col._DECODE_HBM_GBPS_CEILING:
            fail(f"decode_probe implies {out['implied_gbps']} GB/s")
        if int8 and (d.get("int8_matmul", 0) <= 0
                     or d.get("int8_tc") != d.get("int8_matmul")):
            fail(f"decode_probe int8's K7 launches {d}: want all on the "
                 f"tensor cores")
    for k_steps in (1, FUSED_CHAIN):
        probe(f"serving_probe chain_steps={k_steps}", col.serving_probe,
              slots=8, n_requests=24, prompt_len=96, max_new=48,
              chain_steps=k_steps)
    probe("dispatch_probe", col.dispatch_probe)
    out, _ = probe("allreduce_bandwidth", col.allreduce_bandwidth,
                   devices=["cuda"])
    if out["devices"] != 1:
        fail(f"allreduce_bandwidth ran on {out['devices']} devices")
    end = measure_counts(fa, qm)
    counts = {k2: end[k2] - start[k2] for k2 in end}
    print(f"measure (b) the probes' kernel launches: {counts} [{card}]",
          flush=True)

    # (c) profiling: one 154M generation step, traced
    cfg, params = serving_model()
    prompt = torch.randint(0, cfg.vocab, (8, 96),
                           generator=torch.Generator().manual_seed(3)
                           ).to("cuda")
    with torch.no_grad():
        greedy_generate(params, prompt, cfg, 2)          # warm
        torch.cuda.synchronize()
        with profiling.trace(tmp / "trace"):
            with profiling.annotate("measure-generation-step"):
                greedy_generate(params, prompt, cfg, 2)
                torch.cuda.synchronize()
    traces = sorted((tmp / "trace").glob("*.json"))
    if len(traces) != 1:
        fail(f"trace wrote {traces}")
    names = {e.get("name", "") for e in json.loads(
        traces[0].read_text())["traceEvents"]}
    k1_names = sorted(n for n in names if "flash_fwd_sm90_kernel" in n)
    if "measure-generation-step" not in names or not k1_names:
        fail(f"the trace lacks the span or K1 ({len(names)} names)")
    snap = profiling.device_memory_profile(tmp / "memory.pickle")
    print(f"measure (c) trace {traces[0].name}: "
          f"{traces[0].stat().st_size} bytes, {len(names)} event names, "
          f"the annotate span and K1 as {k1_names[0][:60]!r}; device "
          f"memory snapshot {snap.stat().st_size} bytes [{card}]",
          flush=True)
    if snap.stat().st_size <= 0:
        fail("empty device memory snapshot")
    del params
    torch.cuda.empty_cache()

    # (c) the fleet simulator (host only)
    t0 = time.perf_counter()
    out, _ = sim.communicate(timeout=600)
    waited = time.perf_counter() - t0
    if sim.returncode:
        fail(f"the simulator probe exited {sim.returncode}: "
             f"{(sim_dir.parent / 'sim_probe.err').read_text()[-2000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    print(f"measure (c) fleet_sim_probe (host, its own process; this "
          f"phase waited {waited:.1f} s for it): {json.dumps(res)} "
          f"[{card}]", flush=True)
    if (res["sim_replicas"], res["sim_invariant_violations"],
            res["sim_survived_cycles"], res["sim_repro_starved"]) != (
                1000, 0, MEASURE_SIM["cycles"], True):
        fail("fleet_sim_probe: want 1000 replicas, 0 violations, every "
             "cycle survived and the repro starving")
    first = json.loads((sim_dir / "scale" / "sim_soak.json").read_text())
    t0 = time.perf_counter()
    _, fleet = run_sim_soak(
        default_sim_schedule(MEASURE_SIM["seed"],
                             cycles=MEASURE_SIM["cycles"]),
        tmp / "sim_rerun", config=SimConfig(seed=MEASURE_SIM["seed"]))
    digest = fleet.journal_digest()
    print(f"measure (c) same-seed rerun of the 1000-replica soak "
          f"({time.perf_counter() - t0:.1f} s, host): digest {digest[:16]} "
          f"{'==' if digest == first['journal_digest'] else '!='} the "
          f"probe's {first['journal_digest'][:16]}, "
          f"{fleet.heap.processed} events [{card}]", flush=True)
    if digest != first["journal_digest"]:
        fail("the same-seed rerun's journal digest differs")
    print(f"measure: phase wall {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return counts


def main() -> None:
    kind = phase_device()
    from k8s_dra_driver_tpu_torch.models import quant as qm
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine
    from k8s_dra_driver_tpu_torch.ops import _build
    from k8s_dra_driver_tpu_torch.ops import flash_attention as fa
    from k8s_dra_driver_tpu_torch.ops import gmm as gm
    from k8s_dra_driver_tpu_torch.ops import paged_attention as pa

    phase_build(_build)
    k1, k1_probes = phase_flash(fa)
    k1b, k1b_probes = phase_flash_block(fa)
    k2, k2_probes = phase_paged(pa)
    k3, k4, bwd_probes = phase_flash_bwd(fa)
    k5, k6, gmm_probes = phase_gmm(gm)
    k7a, k7b, int8_probes = phase_int8(qm)
    # the fleet simulator's probe runs on the host beside the later
    # phases (after the kernel timings, which it must not disturb)
    sim, sim_dir = start_sim_probe()

    cfg, params = serving_model()
    reqs = s8_r24(cfg.vocab)
    launches = {"flash_fwd": 0, "flash_fwd_tc": 0, "paged_decode": 0}

    done_c, counts, _, _ = drain(ServingEngine, params, cfg, reqs, fa, pa,
                              "contiguous", top_k=50)
    if counts["flash_fwd"] <= 0:
        fail("contiguous drain launched no flash kernel")
    worst = teacher_forced(params, cfg, done_c, reqs)
    print(f"teacher-forced (contiguous): worst gap {worst:.4f} <= "
          f"{TF_MARGIN}", flush=True)
    for name in launches:
        launches[name] += counts[name]

    done_p, counts, stats_p, _ = drain(ServingEngine, params, cfg, reqs, fa,
                                       pa, "paged", top_k=50,
                                       kv_layout="paged")
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

    done_x, counts, stats, _ = drain(
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
    refs = {"bf16 paged": (done_p, stats_p),
            "bf16 paged-preempt": (done_x, stats)}
    del done_c
    counts = phase_int8_serving(params, cfg, reqs, fa, pa)
    for name in ("flash_fwd", "flash_fwd_tc", "paged_decode",
                 "int8_matmul", "int8_bmm", "int8_tc"):
        launches[name] = launches.get(name, 0) + counts[name]
    counts, fused_refs = phase_fused_serving(params, cfg, reqs, fa, pa)
    for name in ("flash_fwd", "flash_fwd_tc", "paged_decode",
                 "int8_matmul", "int8_bmm", "int8_tc"):
        launches[name] = launches.get(name, 0) + counts[name]
    refs.update(fused_refs)
    counts, spec_refs = phase_spec_serving(params, cfg, reqs, fa, pa, refs)
    for name in ("flash_fwd", "flash_fwd_tc", "paged_decode",
                 "int8_matmul", "int8_bmm", "int8_tc"):
        launches[name] = launches.get(name, 0) + counts[name]
    refs.update(spec_refs)
    counts = phase_lora_serving(params, cfg, reqs, fa, pa, refs)
    for name in ("flash_fwd", "flash_fwd_tc", "paged_decode",
                 "int8_matmul", "int8_bmm", "int8_tc"):
        launches[name] = launches.get(name, 0) + counts[name]
    for name, n in phase_disagg_tiers(params, cfg, reqs, fa, pa,
                                      refs).items():
        launches[name] += n
    del refs, fused_refs, spec_refs, done_p, done_x
    for name, n in phase_fleet(params, cfg, reqs, fa, pa).items():
        launches[name] += n
    # the pumps' K1 (f32) joins the flash_fwd entry's f32 route
    for name, n in phase_procfleet(params, cfg, reqs, fa, pa).items():
        launches[name] += n
    del params
    # observability and the fleet control loop: their own 154M weights
    for phase in (phase_observability, phase_fleet_control):
        for name, n in phase(cfg, reqs, fa, pa).items():
            launches[name] += n

    f32_routes = phase_train_small(fa)
    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        counts = phase_train(fa, Path(tmp), record)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    with tempfile.TemporaryDirectory() as tmp:
        gang_bf16, gang_f32 = phase_gang_recovery(fa, pa, Path(tmp))
    for name, n in gang_bf16.items():
        launches[name] = launches.get(name, 0) + n
    for name in ("flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32"):
        f32_routes[name] += gang_f32[name]
    # the crucible: its K1 launches join flash_fwd (both routes: the f32
    # ones count through flash_fwd - flash_fwd_tc), K2 paged_decode,
    # K3/K4 their tensor-core and f32 routes
    with tempfile.TemporaryDirectory() as tmp:
        cru_main, cru_f32 = phase_crucible(fa, pa, Path(tmp))
    for name, n in cru_main.items():
        launches[name] = launches.get(name, 0) + n
    for name, n in cru_f32.items():
        f32_routes[name] += n
    # the sp path's kernels (summed over ranks): K1's block entry, and
    # K3/K4 beside the single-device steps'
    sp = phase_sp_train(fa, record)
    launches["flash_fwd_block_tc"] = sp["block_tc"]
    f32_routes["flash_fwd_block_f32"] = sp["block_f32"]
    launches["flash_bwd_dq_tc"] += sp["dq_tc"]
    launches["flash_bwd_dkv_tc"] += sp["dkv_tc"]

    for name, n in phase_moe_train_small(fa, gm).items():
        f32_routes[name] = f32_routes.get(name, 0) + n
    moe_record = {}
    with tempfile.TemporaryDirectory() as tmp:
        counts = phase_moe_train(fa, gm, Path(tmp), moe_record)
    counts_drain = phase_moe_serving(fa, pa, gm)
    counts_int8 = phase_int8_moe_serving(fa, pa)
    for part in (counts, counts_drain, counts_int8):
        for name, n in part.items():
            launches[name] = launches.get(name, 0) + n
    # tp, ep and pp (summed over ranks): the tensor-core launches join
    # the main path's, the f32 small steps' their routes
    for name, n in phase_mesh_train(fa, gm, record, moe_record).items():
        if name.endswith("_f32"):
            f32_routes[name] = f32_routes.get(name, 0) + n
        else:
            launches[name] = launches.get(name, 0) + n
            if name == "flash_fwd_tc":
                launches["flash_fwd"] += n
    # the measurement utilities: the probes' K1, K3/K4 and K7 launches
    with tempfile.TemporaryDirectory() as tmp:
        for name, n in phase_measure(fa, qm, sim, sim_dir,
                                     Path(tmp)).items():
            launches[name] = launches.get(name, 0) + n
    print(f"kernel launches on the main paths ({30 + DISAGG_DRAINS} "
          f"drains + {FLEET_DRAINS} fleet drains + the process fleet's "
          f"oracle, surviving pumps and codec block + the observability "
          f"drain and paged-KV probes + the control loops and their "
          f"oracle + the gang recovery arcs + the crucible's soaks + "
          f"{TRAIN_STEPS} train "
          f"steps of each of the 154M and moe_heavy + {SP_STEPS} sp steps of the 154M on {SP_WORLD} ranks + the mesh phase's tp, ep and pp steps on {SP_WORLD} ranks + the measurement probes): "
          f"{launches}", flush=True)

    # device time at the main-path shape and at a long context,
    # profiled last: profiling before the drains and the steps would
    # tax their every launch
    for name, row, by_shape in (("K1", k1, k1_probes),
                                ("K1 block", k1b, k1b_probes),
                                ("K2", k2, k2_probes),
                                ("K3", k3, bwd_probes["K3"]),
                                ("K4", k4, bwd_probes["K4"]),
                                ("K5", k5, gmm_probes["K5"]),
                                ("K6", k6, gmm_probes["K6"]),
                                ("K7a", k7a, int8_probes["K7a"]),
                                ("K7b", k7b, int8_probes["K7b"])):
        # K7 as a decode step finds its weights: not in L2
        timer = cold_device_ms if name.startswith("K7") else device_ms
        for shape, probes in by_shape.items():
            times = {what: timer(fn) for what, fn in probes.items()}
            if shape.endswith("(main path)"):
                row["device_ms"] = times["kernel"]
                # no reading of the kernel or its library call may beat
                # the bound
                for key, what in (("ms", "kernel"), ("device_ms", "kernel"),
                                  ("library_ms", "library")):
                    got = row.get(key)
                    if got is not None and got < row["bound_ms"]:
                        row.setdefault("impossible", {})[key] = got
                        row[key] = trusted(f"{name} {shape}", key, got,
                                           row["bound_ms"],
                                           probes.get(what))
            print(f"{name} device_ms at {shape} (kernels only, host gaps "
                  f"excluded): "
                  + " ".join(f"{w}={fmt(t)}" for w, t in times.items()),
                  flush=True)
            if name == "K6" and shape.endswith("(main path)"):
                # K6's library call once read half its bound: its
                # yardstick is also timed cold, beside the kernel's
                row["cold_device_ms"] = {
                    what: cold_device_ms(probes[what])
                    for what in ("kernel", "library") if what in probes}
                print(f"K6 cold device_ms (L2 flushed) at {shape}: "
                      + " ".join(f"{w}={fmt(t)}" for w, t in
                                 row["cold_device_ms"].items()),
                      flush=True)

    # K1 and K5: the tensor-core route the bf16 main paths take; the
    # f32 route's launches (K1: the f32 MoE drains and card steps; K5:
    # the f32 MoE card step) apart
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/flash_fwd_sm90.cu",
             replaces="k8s_dra_driver_tpu/ops/flash_attention.py:122",
             launches=launches["flash_fwd_tc"],
             f32_route_source="k8s_dra_driver_tpu_torch/csrc/flash_fwd.cu",
             f32_route_launches=(launches["flash_fwd"]
                                 - launches["flash_fwd_tc"]
                                 + f32_routes["flash_fwd_f32"]), **k1),
        # K1's block entry, the ring hops of the sp steps (bf16 on the
        # tensor cores); the f32 small ring step's launches apart
        dict(name="flash_fwd_block", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/flash_fwd_sm90.cu",
             replaces="k8s_dra_driver_tpu/ops/flash_attention.py:397",
             launches=launches["flash_fwd_block_tc"],
             f32_route_source="k8s_dra_driver_tpu_torch/csrc/flash_fwd.cu",
             f32_route_launches=f32_routes["flash_fwd_block_f32"], **k1b),
        dict(name="paged_decode", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/paged_decode.cu",
             replaces="k8s_dra_driver_tpu/ops/paged_attention.py:125",
             launches=launches["paged_decode"], **k2),
        # the tensor-core route the bf16 main paths take; the f32
        # route's launches (the f32 card steps of phases 9 and 11) apart
        dict(name="flash_bwd_dq", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/flash_bwd_sm90.cu",
             replaces="k8s_dra_driver_tpu/ops/flash_attention.py:727",
             launches=launches["flash_bwd_dq_tc"],
             f32_route_source="k8s_dra_driver_tpu_torch/csrc/flash_bwd.cu",
             f32_route_launches=f32_routes["flash_bwd_dq_f32"], **k3),
        dict(name="flash_bwd_dkv", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/flash_bwd_sm90.cu",
             replaces="k8s_dra_driver_tpu/ops/flash_attention.py:790",
             launches=launches["flash_bwd_dkv_tc"],
             f32_route_source="k8s_dra_driver_tpu_torch/csrc/flash_bwd.cu",
             f32_route_launches=f32_routes["flash_bwd_dkv_f32"], **k4),
        dict(name="gmm", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/gmm_sm90.cu",
             replaces="k8s_dra_driver_tpu/ops/gmm.py:79",
             launches=launches["gmm_tc"],
             f32_route_source="k8s_dra_driver_tpu_torch/csrc/gmm.cu",
             f32_route_launches=f32_routes["gmm_f32"], **k5),
        dict(name="gmm_dw", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/gmm_dw_sm90.cu",
             replaces="k8s_dra_driver_tpu/ops/gmm.py:126",
             launches=launches["gmm_dw_tc"],
             f32_route_source="k8s_dra_driver_tpu_torch/csrc/gmm.cu",
             f32_route_launches=f32_routes["gmm_dw_f32"], **k6),
        # one source, two routes by x's dtype: the 154M int8 drains'
        # bf16 K7a on the tensor cores, the f32 int8 MoE drain's K7a and
        # K7b on the CUDA cores
        dict(name="int8_matmul", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/int8_matmul_sm90.cu",
             replaces="k8s_dra_driver_tpu/models/quant.py:199",
             launches=launches["int8_matmul"],
             launches_by_route={
                 "tensor_cores": launches["int8_tc"],
                 "cuda_cores": (launches["int8_matmul"]
                                - launches["int8_tc"])},
             **k7a),
        dict(name="int8_bmm", route="cuda",
             source="k8s_dra_driver_tpu_torch/csrc/int8_matmul_sm90.cu",
             replaces="k8s_dra_driver_tpu/models/quant.py:255",
             launches=launches["int8_bmm"],
             launches_by_route={"tensor_cores": 0,
                                "cuda_cores": launches["int8_bmm"]},
             **k7b),
    ]
    if min(k["launches"] for k in kernels) <= 0:
        fail(f"a kernel was never launched on the main paths: {launches}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
