"""Supervisor recovery and resharding probes.

The port of ``k8s_dra_driver_tpu/parallel/probe.py``:

- ``recovery_probe``: a scripted mid-run worker kill through the
  elastic gang supervisor (parallel/supervisor.py), recording what a
  capacity planner needs — MTTR (eviction decision → first completed
  post-resume step, checkpoint restore included) and
  steps-lost-since-checkpoint at two checkpoint cadences, so the
  durability-vs-overhead trade is an artifact instead of a claim.  The
  same keys and defaults as the reference (tp=2; head dim 8, which the
  card's kernels run), plus ``cfg`` (a model config that replaces the
  small default) and ``device``.
- ``resharding_probe``: streaming-restore cost against restore width
  on one generation saved from a dp=2 x tp=4 formation
  (parallel/resharding.py), the reference's keys.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path


def recovery_probe(dp: int = 2, tp: int = 2, batch: int = 4,
                   seq_len: int = 16, steps: int = 6,
                   cadences=(1, 4), kill_after: int = 3,
                   d_model: int = 32, n_layers: int = 2,
                   heads: int = 4, d_ff: int = 64, vocab: int = 64,
                   step_deadline_s: float = 60.0,
                   first_step_deadline_s: float = 300.0,
                   cfg=None, device="cuda") -> dict:
    """One supervised run per checkpoint cadence, each with a scripted
    kill of the last dp worker after ``kill_after`` completed steps.

    Reports per-run MTTR and steps lost, plus the compact-line
    scalars: ``mttr_ms`` (worst run — the honest planning number) and
    ``steps_lost_worst`` (which should track the largest cadence; a
    probe where it exceeds the cadence is flagged invalid, because
    that would mean a generation failed to restore).
    """
    import numpy as np
    import torch

    from ..cluster.faults import FaultPlan, FaultRule
    from ..models import TransformerConfig
    from ..models.checkpoint import TrainCheckpointer
    from .supervisor import ElasticTrainJob, GangSupervisor

    if cfg is None:
        cfg = TransformerConfig(
            vocab=vocab, d_model=d_model, n_layers=n_layers,
            n_heads=heads, d_head=d_model // heads, d_ff=d_ff,
            max_seq=seq_len, dtype=torch.float32)
    motif = np.random.default_rng(0).integers(0, cfg.vocab, 32)
    corpus = np.tile(motif, 64)

    runs = []
    valid = True
    for cadence in cadences:
        job = ElasticTrainJob(cfg, corpus, batch=batch,
                              seq_len=seq_len, tp=tp, device=device)
        # the victim is this formation's last dp row; skip lets
        # kill_after steps complete first (one decision per step)
        plan = FaultPlan([FaultRule(
            verb="gang", kind="Worker", name=f"g0w{dp - 1}",
            skip=kill_after, times=1, error="crash")])
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = TrainCheckpointer(Path(tmp) / "ckpt")
            sup = GangSupervisor(
                job, ckpt, coordination_dir=Path(tmp) / "coord",
                dp=dp, fault_plan=plan,
                step_deadline_s=step_deadline_s,
                first_step_deadline_s=first_step_deadline_s,
                checkpoint_every=cadence)
            t0 = time.perf_counter()
            report = sup.run(steps)
            wall_s = time.perf_counter() - t0
            ckpt.close()
        rec = report.recoveries[0] if report.recoveries else None
        ok = (rec is not None and len(report.recoveries) == 1
              and rec.mttr_s > 0
              and rec.steps_lost <= cadence
              and report.steps == steps
              and all(np.isfinite(l) for _, l in report.losses))
        valid = valid and ok
        runs.append({
            "cadence": cadence,
            "restarts": len(report.recoveries),
            "mttr_ms": round(rec.mttr_s * 1000, 1) if rec else -1.0,
            "steps_lost": rec.steps_lost if rec else -1,
            "dp_from": rec.from_dp if rec else dp,
            "dp_to": rec.to_dp if rec else dp,
            "final_loss": round(float(report.losses[-1][1]), 4)
            if report.losses else -1.0,
            "wall_s": round(wall_s, 2),
        })

    return {
        "dp": dp,
        "tp": tp,
        "steps": steps,
        "kill_after": kill_after,
        "runs": runs,
        "mttr_ms": max(r["mttr_ms"] for r in runs),
        "steps_lost_worst": max(r["steps_lost"] for r in runs),
        "valid": valid,
        "note": ("scripted mid-run worker kill per cadence; MTTR = "
                 "eviction -> first completed post-resume step "
                 "(restore onto the shrunken gang included); "
                 "worst-case scalars surface in the compact line"),
    }


def resharding_probe(d_model: int = 256, n_layers: int = 4,
                     heads: int = 4, d_ff: int = 1024,
                     vocab: int = 512, repeats: int = 5,
                     device="cuda") -> dict:
    """Streaming-restore cost vs restore width, on one saved sharded
    generation (parallel/resharding.py).

    Saves the model (``TransformerConfig``'s default bfloat16, 6.5 MB,
    the reference's bytes) from a dp=2 x tp=4 formation (the save-side
    layout fixes the shard granularity: 4 files per tp-sharded leaf), then measures the WORST-host wall time to read a
    full restore's bytes at restore width 2 and 4 — host ``h`` of ``w``
    reads every ``w``-th shard of each sharded leaf via ``read_slice``
    and the whole of each replicated leaf, the per-host I/O of a
    sharded restore.  ``mono_restore_ms`` is the monolithic-equivalent
    path (one host reads every byte); the claim is ``restore_ms_w4 <=
    ~0.6x`` of it.  ``verify_overhead_x`` prices the crc32 pass
    (verify=True vs verify=False full reads), and ``corrupt_detected``
    proves a bit-flipped shard raises at read time.  The parameters are
    made on ``device`` and saved through the host; everything after the
    save is file I/O on the host, page cache warmed first."""
    import tempfile

    import numpy as np
    import torch

    from ..cluster import faults
    from ..models import TransformerConfig, init_params, transformer_rules
    from .mesh import MeshSpec
    from .resharding import ShardCorruption, ShardedCheckpointer

    cfg = TransformerConfig(
        vocab=vocab, d_model=d_model, n_layers=n_layers, n_heads=heads,
        d_head=d_model // heads, d_ff=d_ff, max_seq=32)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device=device)

    def median_ms(fn) -> float:
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1000.0)
        return float(np.median(times))

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = ShardedCheckpointer(Path(tmp) / "ckpt",
                                   rules=transformer_rules(cfg))
        ckpt.save(0, params, {}, mesh=MeshSpec(dp=2, tp=4))
        leaves = ckpt._read_manifest(ckpt.step_path(0))["leaves"]
        total_bytes = sum(sh["nbytes"] for ent in leaves.values()
                          for sh in ent["shards"])

        def host_read(w: int, h: int) -> None:
            for name, ent in leaves.items():
                shards = ent["shards"]
                if len(shards) < w:      # replicated: every host reads
                    ckpt.read_slice(0, name)
                    continue
                for i, sh in enumerate(shards):
                    if i % w == h:
                        ckpt.read_slice(0, name, bounds=sh["bounds"])

        def full_read(c: ShardedCheckpointer) -> None:
            for name in leaves:
                c.read_slice(0, name)

        full_read(ckpt)                  # warm the page cache
        restore_ms = {
            w: max(median_ms(lambda w=w, h=h: host_read(w, h))
                   for h in range(w))
            for w in (2, 4)}
        mono_ms = median_ms(lambda: full_read(ckpt))
        unverified = ShardedCheckpointer(Path(tmp) / "ckpt",
                                         verify=False)
        mono_nv_ms = median_ms(lambda: full_read(unverified))

        # bit-flip the largest shard; the verified read must raise
        victim_name, victim = max(
            ((n, sh) for n, ent in leaves.items()
             for sh in ent["shards"]),
            key=lambda kv: kv[1]["nbytes"])
        faults.corrupt_file(ckpt.step_path(0) / victim["file"],
                            faults.CORRUPT_BITFLIP, seed=0)
        try:
            ckpt.read_slice(0, victim_name, bounds=victim["bounds"])
            detected = 0
        except ShardCorruption:
            detected = 1

    overhead = mono_ms / mono_nv_ms if mono_nv_ms > 0 else -1.0
    valid = (detected == 1
             and restore_ms[4] <= 0.6 * mono_ms
             and restore_ms[4] <= restore_ms[2])
    return {
        "model_mb": round(total_bytes / 2**20, 2),
        "shards_per_leaf": 4,
        "restore_ms_w2": round(restore_ms[2], 3),
        "restore_ms_w4": round(restore_ms[4], 3),
        "mono_restore_ms": round(mono_ms, 3),
        "w4_vs_mono_x": round(restore_ms[4] / mono_ms, 3)
        if mono_ms > 0 else -1.0,
        "verify_overhead_x": round(overhead, 3),
        "corrupt_detected": detected,
        "valid": valid,
        "note": ("worst-host read time per restore width over one "
                 "dp=2 tp=4 sharded generation; mono = every byte "
                 "through one host (the monolithic-format "
                 "equivalent); page-cache-warm file I/O"),
    }


__all__ = ["recovery_probe", "resharding_probe"]
