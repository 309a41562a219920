"""The simulated soak rig: crucible fault schedules and invariant
sweeps over a thousand-replica fleet.

The port's copy of ``k8s_dra_driver_tpu/sim/rig.py``.
``run_sim_soak`` has the live crucible's soak signature,
``(schedule, workdir, *, dump_dir=None, drain_cycles=0, **kw) ->
(CrucibleResult, fleet)``, so ``cluster/crucible.py``'s ddmin
minimizer, repro replay and ``investigate`` workflow drive the
SIMULATED fleet through their ``soak=`` seam without modification (they
call ``soak(sub, workdir)`` and ``soak(sched, workdir, dump_dir=,
drain_cycles=)``): a pathology found at 1000 replicas is delta-debugged
by the same code that minimizes 8-chip soaks, and the minimized
schedule replays deterministically.  It runs on the host.

Fault mapping (the fidelity contract of sim/workload.py): the sim
models timing/capacity/placement/lifecycle, so ``chip_kill`` (health
fence + replica kills + gang eviction + scheduled heal),
``worker_crash`` / ``worker_hang`` (gang eviction + reform),
``replica_kill`` and ``burst`` are fully live.  The byte-level kinds,
the corruption trio (``shard_bitflip``/``shard_truncate``/
``gen_tear``), ``kv_exhaust``, ``pump_kill``, ``adapter_evict_storm``
and ``tier_corrupt``, are journal-logged no-ops here: there are no
bytes to damage, and the live crucible owns those arcs.
Window-triggered events honor the live semantics: fire at the first
cycle >= ``after_cycle`` where an open window matches the glob
(cascade / reform:<gang> / parked:<gang>), recording ``hit_windows``.
"""

from __future__ import annotations

import fnmatch
import json
import zlib
from pathlib import Path

from ..cluster.crucible import (CASCADE_KINDS, CASCADE_WINDOW_S,
                                CrucibleResult, FaultEvent, Schedule)
from .fleet import SPIKE, FleetSim, SimConfig, build_fleet

#: fault kinds that are logged no-ops on the simulated fleet (the
#: fidelity contract above) — everything else actuates
NOOP_KINDS = frozenset({"shard_bitflip", "shard_truncate", "gen_tear",
                        "kv_exhaust", "pump_kill",
                        "adapter_evict_storm", "tier_corrupt"})


def _open_windows(fleet: FleetSim) -> list[str]:
    """The arcs currently open, named like the live rig's windows."""
    out = []
    now = fleet.heap.now
    for t, kind, _ in reversed(fleet.recon.events):
        if now - t > CASCADE_WINDOW_S:
            break
        if kind in CASCADE_KINDS:
            out.append("cascade")
            break
    for name, sup in fleet.sups.items():
        if sup.state == "parked":
            out.append(f"parked:{name}")
        elif sup.workers and any(not w.alive for w in sup.workers):
            out.append(f"reform:{name}")
    return out


def _due(ev: FaultEvent, cycle: int, windows: list[str]) -> bool:
    if ev.fired_cycle is not None:
        return False
    if ev.window is not None:
        return (cycle >= ev.after_cycle
                and any(fnmatch.fnmatch(w, ev.window)
                        for w in windows))
    return cycle >= ev.at_cycle


def _pick_chip(fleet: FleetSim, ev: FaultEvent) -> int:
    if ev.chip is not None:
        return int(ev.chip)
    # deterministic, schedule-stable pick (no Python hash(): that is
    # per-process randomized)
    return zlib.crc32(ev.id.encode()) % len(fleet.ledger.chips)


def _apply_fault(fleet: FleetSim, ev: FaultEvent, cycle: int,
                 heals: list) -> None:
    now = fleet.heap.now
    if ev.kind in NOOP_KINDS:
        fleet.journal.append((now, f"fault.{ev.kind}",
                              {"id": ev.id, "noop": True}))
        return
    if ev.kind == "chip_kill":
        chip = _pick_chip(fleet, ev)
        fleet.health[chip] = f"fault:{ev.id}"
        for gw in fleet.gateways.values():
            for r in gw.replicas_on_chips([chip]):
                gw.kill_replica(r, "chip_kill")
        for sup in fleet.sups.values():
            if chip in sup.chips():
                sup.on_chip_down([chip])
        if ev.heal_after:
            heals.append((cycle + int(ev.heal_after), chip))
        fleet.journal.append((now, "fault.chip_kill",
                              {"id": ev.id, "chip": chip}))
        return
    if ev.kind in ("worker_crash", "worker_hang"):
        # a hang is detected-then-restarted on the live rig; in the
        # timing model both collapse to evict + reform
        name = ev.gang or next(iter(fleet.sups), None)
        sup = fleet.sups.get(name)
        if sup is not None:
            sup.crash_worker(ev.row or 0, ev.kind)
        fleet.journal.append((now, f"fault.{ev.kind}",
                              {"id": ev.id, "gang": name}))
        return
    if ev.kind == "replica_kill":
        glob = ev.replica_glob or "*"
        for gw_name in sorted(fleet.gateways):
            gw = fleet.gateways[gw_name]
            for r in gw.manager.replicas:
                if r.state != "dead" and fnmatch.fnmatch(r.name,
                                                         glob):
                    gw.kill_replica(r, "replica_kill")
                    fleet.journal.append(
                        (now, "fault.replica_kill",
                         {"id": ev.id, "replica": r.name}))
                    return
        fleet.journal.append((now, "fault.replica_kill",
                              {"id": ev.id, "replica": None}))
        return
    if ev.kind == "burst":
        target = SPIKE
        if ev.replica_glob:
            for gw_name in sorted(fleet.gateways):
                if fnmatch.fnmatch(gw_name, ev.replica_glob):
                    target = gw_name
                    break
        gw = fleet.gateways[target]
        n = ev.n or 16
        for k in range(n):
            gw.submit(f"{ev.id}-{k}", slo_s=ev.slo_s)
        fleet.journal.append((now, "fault.burst",
                              {"id": ev.id, "gw": target, "n": n}))
        return
    raise ValueError(f"unmapped fault kind {ev.kind!r}")


def run_sim_soak(schedule: Schedule, workdir, *, dump_dir=None,
                 drain_cycles: int = 0,
                 config: SimConfig | None = None
                 ) -> tuple[CrucibleResult, FleetSim]:
    """One simulated soak: build the fleet, advance virtual time
    cycle by cycle, fire due faults, tick the REAL reconciler, sweep
    the REAL invariants (+ the sim-layer starvation detector), then
    run the end-of-run exactly-once checkers.  Returns
    ``(CrucibleResult, fleet)`` — the crucible's soak contract, so
    ``minimize``/``replay``/``investigate`` accept this via their
    ``soak=`` seam."""
    cfg = config or SimConfig.tiny()
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    fleet = build_fleet(cfg)
    # fresh() copies: firing records (fired_cycle/hit_windows) are
    # per-RUN state, and minimize() re-soaks the same event objects
    events = [e.fresh() for e in schedule.events]
    heals: list[tuple[int, int]] = []
    violations: list[tuple[int, list]] = []
    total = schedule.cycles + drain_cycles
    for cycle in range(total):
        for heal_cycle, chip in list(heals):
            if cycle >= heal_cycle:
                fleet.health.pop(chip, None)
                heals.remove((heal_cycle, chip))
                fleet.journal.append((fleet.heap.now, "fault.heal",
                                     {"chip": chip}))
        fleet.heap.run(until=(cycle + 1) * cfg.cycle_s)
        if cycle < schedule.cycles:
            windows = _open_windows(fleet)
            for ev in events:
                if _due(ev, cycle, windows):
                    ev.fired_cycle = cycle
                    if ev.window is not None:
                        ev.hit_windows = tuple(
                            w for w in windows
                            if fnmatch.fnmatch(w, ev.window))
                    _apply_fault(fleet, ev, cycle, heals)
        applied = fleet.recon.tick()
        bad = fleet.check() + fleet.check_starvation(applied)
        if bad:
            violations.append((cycle, bad))
    # teardown drain: run virtual time past every outstanding
    # deadline (in-flight work completes, dispatchable queues drain),
    # then shed what a replica never existed to serve — after which
    # the end-of-run exactly-once sweep is owed a clean fleet
    horizon = max((req.deadline_s
                   for gw in fleet.gateways.values()
                   for req in gw.queue._q
                   if req.deadline_s is not None),
                  default=fleet.heap.now)
    # arrivals are heap-scheduled up front and may extend past the
    # soak: drain to the build-time arrival horizon too, or late
    # tail arrivals would queue after the shed and flunk the
    # exactly-once sweep with zero terminal outcomes
    horizon = max(horizon, getattr(fleet, "arrival_horizon_s", 0.0),
                  fleet.heap.now)
    fleet.heap.run(until=horizon + 1.0)
    for gw in fleet.gateways.values():
        gw.expire_queued()
    end_bad = fleet.end_of_run()
    if end_bad:
        violations.append((-1, end_bad))
    fired = [e for e in events if e.fired_cycle is not None]
    mttrs = [r.mttr_s for sup in fleet.sups.values()
             for r in sup.recoveries if r.cause != "resize"]
    finished = sum(
        1 for gw in fleet.gateways.values()
        for o in gw.outcomes.values() if o.status == "finished")
    first_cycle_bad = min((c for c, _ in violations if c >= 0),
                          default=None)
    result = CrucibleResult(
        cycles=total,
        survived_cycles=(total if first_cycle_bad is None
                         else first_cycle_bad),
        violations=violations,
        overlap_hits=sum(1 for e in fired
                         if e.kind != "burst" and e.hit_windows),
        fault_kinds_fired=sorted({e.kind for e in fired}),
        compound_mttr_ms=(sum(mttrs) / len(mttrs) * 1000.0
                          if mttrs else 0.0),
        submitted=sum(gw.admissions_total
                      for gw in fleet.gateways.values()),
        finished=finished,
        operator_repairs=0,
        gang_failures=[name for name, sup in fleet.sups.items()
                       if sup.state == "running"
                       and not any(w.alive for w in sup.workers)])
    summary = {
        "config": {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in vars(cfg).items()
                   if not k.startswith("_") and k != "mt_config"},
        "cycles": total,
        "events_processed": fleet.heap.processed,
        "journal_digest": fleet.journal_digest(),
        "violations": [[c, msgs] for c, msgs in violations],
        "fault_kinds_fired": result.fault_kinds_fired,
        "fragmentation": fleet.fragmentation(),
    }
    (workdir / "sim_soak.json").write_text(
        json.dumps(summary, indent=1) + "\n")
    if dump_dir is not None:
        dump_dir = Path(dump_dir)
        dump_dir.mkdir(parents=True, exist_ok=True)
        (dump_dir / "journal.json").write_text(json.dumps(
            [list(e) for e in fleet.journal], default=str) + "\n")
    return result, fleet


def sim_soak_for(config: SimConfig, **fixed):
    """Bind a config (and any fixed kwargs) into the crucible's
    ``soak=`` seam: ``minimize(schedule, workdir,
    soak=sim_soak_for(cfg))`` delta-debugs a fleet-scale pathology
    with the stock ddmin loop."""
    def soak(schedule, workdir, **kw):
        merged = dict(fixed)
        merged.update(kw)
        merged.setdefault("config", config)
        return run_sim_soak(schedule, workdir, **merged)
    return soak


def default_sim_schedule(seed: int = 7, cycles: int = 60) -> Schedule:
    """The canonical fleet-scale chaos composition: chip deaths into
    gang and pool chips (with heals), worker faults, a newcomer
    pressure wave aimed at the reclaim cascade, a window-triggered
    chip kill inside that cascade, and the byte-level kinds riding
    along as logged no-ops so the roster coverage pin sees every
    registered kind."""
    u = max(cycles // 10, 3)
    events = [
        # gang arc: chip death -> reform -> second death in-window
        FaultEvent(id="gang-chip", kind="chip_kill", at_cycle=u,
                   chip=1, heal_after=2 * u),
        FaultEvent(id="gang-chip-in-reform", kind="chip_kill",
                   window="reform:gang-0", after_cycle=u, chip=2,
                   heal_after=2 * u),
        FaultEvent(id="gang-crash", kind="worker_crash",
                   at_cycle=2 * u, gang="gang-0", row=0),
        FaultEvent(id="gang-hang", kind="worker_hang",
                   at_cycle=3 * u, gang="gang-0", row=0),
        # serving arc: replica death + a pool chip death
        FaultEvent(id="pool-replica", kind="replica_kill",
                   at_cycle=2 * u + 1, replica_glob="pool-0-r*"),
        FaultEvent(id="pool-chip", kind="chip_kill", at_cycle=3 * u,
                   heal_after=u),
        # newcomer pressure: back-to-back waves hold the spike queue
        # over queue_high across ticks, arming the grant/cascade path
        FaultEvent(id="spike-wave", kind="burst", at_cycle=4 * u,
                   n=24),
        FaultEvent(id="spike-wave-2", kind="burst",
                   at_cycle=4 * u + 1, n=24),
        FaultEvent(id="chip-in-cascade", kind="chip_kill",
                   window="cascade", after_cycle=4 * u, heal_after=u),
        # byte-level kinds: logged no-ops on the sim (fidelity
        # contract), so schedules stay portable to the live rig
        FaultEvent(id="noop-bitflip", kind="shard_bitflip",
                   at_cycle=5 * u, gang="gang-0"),
        FaultEvent(id="noop-truncate", kind="shard_truncate",
                   at_cycle=5 * u + 1, gang="gang-0"),
        FaultEvent(id="noop-tear", kind="gen_tear",
                   at_cycle=5 * u + 2, gang="gang-0"),
        FaultEvent(id="noop-kv", kind="kv_exhaust",
                   at_cycle=6 * u, replica_glob="pool-1-r*",
                   heal_after=2),
        FaultEvent(id="noop-pump", kind="pump_kill",
                   at_cycle=6 * u + 1, replica_glob="pump*"),
        FaultEvent(id="noop-adapter-storm", kind="adapter_evict_storm",
                   at_cycle=6 * u + 2, replica_glob="pool-0-r*",
                   heal_after=2),
        FaultEvent(id="noop-tier-corrupt", kind="tier_corrupt",
                   at_cycle=6 * u + 3, replica_glob="pool-1-r*"),
        FaultEvent(id="tail-wave", kind="burst", at_cycle=8 * u,
                   n=12, replica_glob="pool-1"),
    ]
    return Schedule(seed=seed, cycles=cycles, events=events)


__all__ = ["NOOP_KINDS", "default_sim_schedule", "run_sim_soak",
           "sim_soak_for"]
