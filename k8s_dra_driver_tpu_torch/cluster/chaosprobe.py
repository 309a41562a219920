"""Crucible probe: the compound-fault soak as one row of scalars.

The port of ``k8s_dra_driver_tpu/cluster/chaosprobe.py``, with the
reference's keys: ``cru_survived_cycles`` (must equal the schedule
length), ``cru_invariant_violations`` (must be 0),
``cru_compound_mttr_ms`` (mean gang-recovery MTTR under overlapping
faults) and ``cru_overlap_hits`` (how many faults landed inside another
fault's recovery window; a soak that composes nothing proves nothing).

    python -m k8s_dra_driver_tpu_torch.cluster.chaosprobe --cycles 90 \\
        --device cpu

runs the default model (head dim 8) on the CPU; without ``--device``
it runs on the card, where the attention kernels run at head dim 8.
"""

from __future__ import annotations


def crucible_probe(seed: int = 7, cycles: int = 90, workdir=None,
                   device="cuda", model=None, gang_cfg=None) -> dict:
    """Run :func:`~.crucible.default_schedule` through one soak and
    flatten the verdict to scalars."""
    import tempfile
    import time
    t0 = time.perf_counter()
    from .crucible import default_schedule, run_soak
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="crucible-probe-")
    sched = default_schedule(seed, cycles=cycles)
    res, _rig = run_soak(sched, workdir, model=model, gang_cfg=gang_cfg,
                         device=device)
    return {
        "cru_survived_cycles": res.survived_cycles,
        "cru_compound_mttr_ms": round(res.compound_mttr_ms, 3),
        "cru_invariant_violations": sum(
            len(v) for _, v in res.violations),
        "cru_overlap_hits": res.overlap_hits,
        "cru_fault_kinds": len(res.fault_kinds_fired),
        "cru_finished": res.finished,
        "cru_submitted": res.submitted,
        "cru_operator_repairs": res.operator_repairs,
        "cru_wall_s": round(time.perf_counter() - t0, 3),
        "note": (f"seeded compound-fault soak: seed={seed} "
                 f"cycles={cycles}, kinds={res.fault_kinds_fired}"),
    }


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cycles", type=int, default=90)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    print(json.dumps(crucible_probe(seed=ns.seed, cycles=ns.cycles,
                                    workdir=ns.workdir, device=ns.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
