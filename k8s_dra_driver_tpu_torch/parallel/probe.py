"""Supervisor recovery probe: MTTR + steps-lost vs checkpoint cadence.

The port's ``recovery_probe`` from ``k8s_dra_driver_tpu/parallel/
probe.py``: a scripted mid-run worker kill through the elastic gang
supervisor (parallel/supervisor.py), recording what a capacity planner
needs — MTTR (eviction decision → first completed post-resume step,
checkpoint restore included) and steps-lost-since-checkpoint at two
checkpoint cadences, so the durability-vs-overhead trade is an
artifact instead of a claim.  The same keys as the reference, plus
``cfg`` (a model config that replaces the small default; on the card
K1 needs a head dim of 64 or 128) and ``device``.  ``tp`` defaults to
1: the port has no tp axis yet (ROADMAP Queue A item 6b).  The
reference's ``resharding_probe`` saves from a dp=2 x tp=4 mesh and
waits for that axis.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path


def recovery_probe(dp: int = 2, tp: int = 1, batch: int = 4,
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


__all__ = ["recovery_probe"]
