"""Fleet-simulator probe: the thousand-replica soak as flat scalars.

The port's copy of ``k8s_dra_driver_tpu/sim/probe.py``.  Evidence that
the discrete-event simulator (sim/fleet.py) still drives the port's
policy layer at headline scale.  The simulator runs on the host: no
tensor, no device.

- ``sim_replicas``: fleet size the soak ran at (the headline 1000);
- ``sim_events_per_s``: heap events processed per wall second over the
  full-scale soak, the O(events) throughput figure (idle replicas cost
  nothing, so this measures work, not population);
- ``sim_pathology_repro_ms``: wall milliseconds to replay the
  ddmin-minimized drain-starvation repro on the testbed-sized
  ``SimConfig.repro()`` fleet with the fix DISABLED: the found
  pathology stays replayable and cheap.

The probe also records the packed-vs-spread contended A/B (the
fragmentation split that produced the pathology) and the pre-fix
against post-fix starvation verdict.

Run: ``python -m k8s_dra_driver_tpu_torch.sim.probe [--seed 7]
[--cycles 20] [--ab-cycles 70] [--workdir DIR]`` prints one JSON line.
"""

from __future__ import annotations


def _starved(res) -> bool:
    return any("starvation" in m
               for _, msgs in res.violations for m in msgs)


def fleet_sim_probe(seed: int = 7, cycles: int = 20,
                    ab_cycles: int = 70, workdir=None) -> dict:
    """One full probe: headline-scale soak, contended A/B, and the
    minimized-pathology replay, flattened to scalars."""
    import tempfile
    import time
    from pathlib import Path

    from ..cluster import crucible
    from ..fleet.tenancy import MtConfig
    from .fleet import SimConfig
    from .rig import default_sim_schedule, run_sim_soak, sim_soak_for

    t_all = time.perf_counter()
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="fleet-sim-probe-")
    workdir = Path(workdir)

    # 1. headline-scale soak: 1000 replicas, 64 domains, 10k tenants
    #    under the default compound-fault schedule
    cfg = SimConfig(seed=seed)
    sched = default_sim_schedule(seed, cycles=cycles)
    t0 = time.perf_counter()
    res, fleet = run_sim_soak(sched, workdir / "scale", config=cfg)
    wall = time.perf_counter() - t0
    events = fleet.heap.processed

    # 2. contended A/B: same shape, packed vs spread placement —
    #    the fragmentation split behind the found pathology
    burst = crucible.Schedule(seed=seed, cycles=ab_cycles, events=[
        crucible.FaultEvent(id="spike-wave", kind="burst",
                            at_cycle=6, n=48),
        crucible.FaultEvent(id="spike-wave-2", kind="burst",
                            at_cycle=7, n=48),
    ])
    ab = {}
    for placement in ("packed", "spread"):
        for fix in (False, True):
            c = SimConfig.contended(
                placement, seed=seed, calm_floor=104,
                mt_config=MtConfig(domain_aware_drain=fix))
            r, f = run_sim_soak(
                burst, workdir / f"ab-{placement}-{fix}", config=c)
            grants = [t for t, k, i in f.recon.events
                      if k == "grant" and i.get("tenant") == "spike"]
            key = f"{placement}_{'fixed' if fix else 'prefix'}"
            ab[key] = {
                "starved": _starved(r),
                "spike_grant_t": grants[0] if grants else None,
                "drains": sum(1 for t, k, i in f.recon.events
                              if k == "reclaim_drain"),
                **f.fragmentation(),
            }

    # 3. minimized-pathology replay on the testbed-sized fleet with
    #    the fix disabled (the repro must still starve)
    repro_cfg = SimConfig.repro(
        seed=seed, mt_config=MtConfig(domain_aware_drain=False))
    soak = sim_soak_for(repro_cfg)
    noisy = crucible.Schedule(seed=seed, cycles=30, events=[
        crucible.FaultEvent(id="gang-chip", kind="chip_kill",
                            at_cycle=1, chip=1),
        crucible.FaultEvent(id="spike-wave", kind="burst",
                            at_cycle=2, n=24),
        crucible.FaultEvent(id="bitflip", kind="shard_bitflip",
                            at_cycle=4),
        crucible.FaultEvent(id="tear", kind="gen_tear", at_cycle=6),
    ])
    minimized, runs = crucible.minimize(noisy, workdir / "ddmin",
                                        soak=soak, check=_starved)
    min_res, _ = soak(minimized, workdir / "minimized")
    repro = crucible.write_repro(workdir / "repro.json", minimized,
                                 min_res)
    t0 = time.perf_counter()
    rep_res, _rep = crucible.replay(repro, workdir / "replay",
                                    soak=soak)
    repro_ms = 1000 * (time.perf_counter() - t0)

    return {
        "sim_replicas": cfg.n_replicas,
        "sim_events_per_s": round(events / max(wall, 1e-9), 1),
        "sim_pathology_repro_ms": round(repro_ms, 1),
        "sim_events": events,
        "sim_soak_wall_s": round(wall, 3),
        "sim_survived_cycles": res.survived_cycles,
        "sim_invariant_violations": sum(
            len(v) for _, v in res.violations),
        "sim_fault_kinds": len(res.fault_kinds_fired),
        "sim_chips": cfg.n_chips,
        "sim_tenants": cfg.n_tenants,
        "sim_minimized_events": len(minimized.events),
        "sim_ddmin_runs": runs,
        "sim_repro_starved": _starved(rep_res),
        "ab": ab,
        "probe_wall_s": round(time.perf_counter() - t_all, 3),
        "note": (f"seeded fleet soak: seed={seed} cycles={cycles}, "
                 f"replicas={cfg.n_replicas}, "
                 f"domains={cfg.n_domains}"),
    }


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--ab-cycles", type=int, default=70)
    ap.add_argument("--workdir", default=None)
    ns = ap.parse_args(argv)
    print(json.dumps(fleet_sim_probe(
        seed=ns.seed, cycles=ns.cycles, ab_cycles=ns.ab_cycles,
        workdir=ns.workdir)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
