"""Fleet reconciler probes: arbitration latency as artifacts.

The port of ``k8s_dra_driver_tpu/fleet/probe.py``, over the port's
engines, gateways and gang supervisor.  ``fleet_probe`` drives the 1x1
reconciler through one scripted contention cycle — burst → preempt the
gang → serve on the freed chips → calm → retire → regrow — recording
what a capacity planner needs:

- ``scaleup_ms``    — burst start → first replica scale-up actuated
  (hysteresis + the preempt wait included: with no free chips, the
  scale-up CANNOT fire before the gang gives ground);
- ``preempt_ms``    — preempt request → first request FINISHED on the
  replica standing on the freed chips (preemption-to-serving MTTR:
  checkpoint, shrink reform, replica spawn, dispatch, decode);
- ``regrow_ms``     — regrow request → first completed train step at
  full width (EXPAND reform + restore included).

``multitenant_probe`` drives the NxN arbiter (fleet/tenancy.py)
through one two-tenant contention cycle and records the cascade MTTR
(``preempt_cascade_ms``), the bin-packer's anti-fragmentation win over
naive first-fit (``frag_win_x``, from the pure-host
``fragmentation_probe``), and the fair-share allocation error
(``fairshare_err``).  Entry points default to the card
(``device="cuda"``); the CPU runs them with ``device="cpu"``.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path


def fleet_probe(tp: int = 2, train_dp: int = 2, batch: int = 4,
                seq_len: int = 16, n_requests: int = 10,
                max_new: int = 4, slots: int = 2,
                d_model: int = 32, n_layers: int = 2, heads: int = 4,
                d_ff: int = 64, vocab: int = 64,
                max_rounds: int = 600, slo_s: float = 300.0,
                cfg=None, device="cuda") -> dict:
    """One contention cycle through gateway + supervisor + reconciler
    (module docstring).  The ledger holds ``train_dp*tp`` gang chips
    plus ONE serving chip, so the burst's scale-up has no free supply
    and MUST preempt — the arbitration path is what is being timed.
    ``cfg`` replaces the small default config (head dim 8, which the
    card's kernels run); ``tp`` defaults to 2, as in the reference.
    """
    import numpy as np
    import torch

    from ..fleet import (ChipLedger, FleetPolicy, FleetReconciler,
                         PolicyConfig)
    from ..models import TransformerConfig, init_params
    from ..models.checkpoint import TrainCheckpointer
    from ..models.serving import Request, ServingEngine
    from ..gateway import FleetGateway, ReplicaManager
    from ..parallel.supervisor import ElasticTrainJob, GangSupervisor

    if cfg is None:
        cfg = TransformerConfig(
            vocab=vocab, d_model=d_model, n_layers=n_layers,
            n_heads=heads, d_head=d_model // heads, d_ff=d_ff,
            max_seq=max(seq_len, 32), dtype=torch.float32)
    vocab = cfg.vocab
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device=device)
    rng = np.random.default_rng(0)
    motif = rng.integers(0, vocab, 32)

    gang_chips = train_dp * tp
    chips = list(range(gang_chips + 1))       # + one serving chip

    with tempfile.TemporaryDirectory() as tmp:
        job = ElasticTrainJob(cfg, np.tile(motif, 64), batch=batch,
                              seq_len=seq_len, tp=tp,
                              device=device)
        ckpt = TrainCheckpointer(Path(tmp) / "ckpt")
        sup = GangSupervisor(job, ckpt,
                             coordination_dir=Path(tmp) / "coord",
                             dp=train_dp, checkpoint_every=2,
                             step_deadline_s=120.0,
                             first_step_deadline_s=600.0)
        mgr = ReplicaManager(
            lambda name: ServingEngine(params, cfg, slots=slots,
                                       device=device),
            replicas=1, chip_of=lambda name: chips[-1],
            depth_bound=slots)
        gw = FleetGateway(mgr, queue_capacity=4 * n_requests,
                          auto_replace=False)
        ledger = ChipLedger(chips)
        policy = FleetPolicy(PolicyConfig(
            queue_high=3, up_after=1, down_after=2, regrow_after=2,
            min_replicas=1, max_replicas=3, min_train_dp=1,
            arrival_low_rps=1e9))
        rec = FleetReconciler(gw, sup, ledger=ledger, policy=policy)

        sup.begin(10_000)                      # stopped by the probe
        sup_live = True

        def pump():
            nonlocal sup_live
            gw.step()
            if sup_live:
                sup_live = sup.step_once()
            rec.tick()

        def first_event(kind):
            for t, k, info in rec.events:
                if k == kind:
                    return t, info
            return None, None

        # -- phase A: burst against a dry pool --------------------------
        t_burst = time.monotonic()
        for i in range(n_requests):
            gw.submit(Request(
                uid=f"f{i}",
                prompt=rng.integers(0, vocab, 8).astype(np.int32),
                max_new=max_new), slo_s=slo_s)
        new_replica = None
        t_served = None
        rounds = 0
        while rounds < max_rounds:
            rounds += 1
            pump()
            if new_replica is None:
                _, info = first_event("scale_up")
                if info:
                    new_replica = info["replica"]
            if new_replica is not None and t_served is None:
                if any(g.status == "finished"
                       and g.replica == new_replica
                       for g in gw.outcomes.values()):
                    t_served = time.monotonic()
            if (t_served is not None and not len(gw.queue)
                    and not any(r.in_flight for r in mgr.replicas)):
                break
        t_up, _ = first_event("scale_up")
        t_pre, _ = first_event("preempt")

        # -- phase B: calm → retire → regrow ----------------------------
        t_regrown = None
        while rounds < max_rounds:
            rounds += 1
            pump()
            t_rg, _ = first_event("regrow")
            if (t_rg is not None and sup.dp == train_dp
                    and sup.state == "running"
                    and sup.losses
                    and sup.recoveries
                    and sup.recoveries[-1].cause == "expand"
                    and sup._step > sup.recoveries[-1].restored_step):
                t_regrown = time.monotonic()
                break
        t_rg, _ = first_event("regrow")

        report = sup.report()
        ckpt.close()

    steps = [s for s, _ in report.losses]
    exactly_once = steps == list(range(1, len(steps) + 1))
    finished = sum(1 for g in gw.outcomes.values()
                   if g.status == "finished")
    causes = [r.cause for r in report.recoveries]
    valid = (t_up is not None and t_pre is not None
             and t_rg is not None and t_served is not None
             and t_regrown is not None
             and t_pre < t_up                 # preempt unblocked the up
             and finished == n_requests and exactly_once
             and causes == ["preempt", "expand"]
             and all(r.steps_lost == 0 for r in report.recoveries)
             and report.dp == train_dp)

    def ms(a, b):
        return round((b - a) * 1000, 1) if None not in (a, b) else -1.0

    return {
        "chips": len(chips),
        "train_dp": train_dp,
        "tp": tp,
        "requests": n_requests,
        "rounds": rounds,
        "scaleup_ms": ms(t_burst, t_up),
        "preempt_ms": ms(t_pre, t_served),
        "regrow_ms": ms(t_rg, t_regrown),
        "train_steps": report.steps,
        "finished": finished,
        "recovery_causes": causes,
        "steps_lost": [r.steps_lost for r in report.recoveries],
        "exactly_once": exactly_once,
        "valid": valid,
        "note": ("scripted contention cycle: burst -> "
                 "checkpoint-then-shrink preempt -> serve on freed "
                 "chips -> calm -> retire -> EXPAND regrow; "
                 "preempt_ms is preemption-to-serving MTTR, regrow_ms "
                 "is regrow-to-full-width (reform + restore "
                 "included)"),
    }




def fragmentation_probe(n_chips: int = 8, domain_size: int = 2) -> dict:
    """Packed vs naive placement, pure host logic: a gang
    plus two serving tenants interleave single-chip allocations, one
    serving tenant later retires, and the question is how wide a gang
    the freed board can regrow.  Naive first-fit interleaves the two
    serving tenants across adjacent chips, so the retiring tenant
    hands back non-contiguous holes; the bin-packer's domain
    exclusivity + distance scoring keeps each tenant's chips
    clustered, so the same retirement frees one contiguous block next
    to the gang.  ``frag_win_x`` = packed regrow width / naive regrow
    width (power-of-two gang widths, the real regrow rule)."""
    from .binpack import TopologyBinPacker
    from .supply import (ChipLedger, owner_tenant, serving_tag,
                         training_tag)

    def run(packed: bool) -> int:
        ledger = ChipLedger(list(range(n_chips)))
        packer = TopologyBinPacker(ledger, domain_size=domain_size)
        # the gang holds the head block
        ledger.owners[0] = training_tag("gang")
        ledger.owners[1] = training_tag("gang")
        # serving tenants A and B alternate four single-chip grows
        for i, tenant in enumerate(("A", "B", "A", "B")):
            if packed:
                chip = packer.place_chip(tenant)
            else:
                free = packer.naive_first_fit(1)
                chip = free[0] if free else None
            assert chip is not None, "board unexpectedly full"
            ledger.owners[chip] = serving_tag(tenant, f"r{i}")
        # B retires: its chips return to the pool
        for c, owner in list(ledger.owners.items()):
            if owner_tenant(owner) == "B":
                ledger.owners[c] = None
        # how wide can the gang regrow (pow2, counting its own chips)?
        dp, best = 1, 0
        while dp <= n_chips:
            if ledger.contiguous_available(
                    dp, include=training_tag("gang")):
                best = dp
            dp *= 2
        return best

    packed_w, naive_w = run(packed=True), run(packed=False)
    return {
        "chips": n_chips,
        "domain_size": domain_size,
        "packed_regrow": packed_w,
        "naive_regrow": naive_w,
        "frag_win_x": round(packed_w / max(naive_w, 1), 2),
        "note": ("gang@head + 2 serving tenants alternating 4 grows, "
                 "then one tenant retires; regrow width = largest "
                 "pow2 contiguous run counting the gang's own chips"),
    }


def multitenant_probe(tp: int = 1, train_dp: int = 2, batch: int = 4,
                      seq_len: int = 16, n_requests: int = 10,
                      max_new: int = 4, slots: int = 2,
                      d_model: int = 32, n_layers: int = 2,
                      heads: int = 4, d_ff: int = 64, vocab: int = 64,
                      max_rounds: int = 600,
                      slo_s: float = 300.0, cfg=None,
                      device="cuda") -> dict:
    """One two-tenant contention cycle through the N×N arbiter
    (module docstring): a high-priority serving tenant bursts against
    a board whose only reclaimable supply is a floor-zero
    low-priority gang — the cascade must PARK the gang (checkpoint,
    release everything), grant the freed chips, serve the burst, then
    calm-release and regrow the gang from its parked checkpoint.
    ``cfg`` and ``device`` as in :func:`fleet_probe`.
    """
    import numpy as np
    import torch

    from ..gateway import FleetGateway, ReplicaManager
    from ..models import TransformerConfig, init_params
    from ..models.checkpoint import TrainCheckpointer
    from ..models.serving import Request, ServingEngine
    from ..parallel.supervisor import ElasticTrainJob, GangSupervisor
    from .binpack import TopologyBinPacker
    from .supply import ChipLedger
    from .tenancy import (MtConfig, MultiTenantReconciler,
                          ServingTenant, TenantRegistry, TenantSpec,
                          TrainingTenant)

    if cfg is None:
        cfg = TransformerConfig(
            vocab=vocab, d_model=d_model, n_layers=n_layers,
            n_heads=heads, d_head=d_model // heads, d_ff=d_ff,
            max_seq=max(seq_len, 32), dtype=torch.float32)
    vocab = cfg.vocab
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device=device)
    rng = np.random.default_rng(0)
    motif = rng.integers(0, vocab, 32)

    gang_chips = train_dp * tp
    chips = list(range(gang_chips + 1))       # + one serving chip

    with tempfile.TemporaryDirectory() as tmp:
        job = ElasticTrainJob(cfg, np.tile(motif, 64), batch=batch,
                              seq_len=seq_len, tp=tp,
                              device=device)
        ckpt = TrainCheckpointer(Path(tmp) / "ckpt")
        sup = GangSupervisor(
            job, ckpt, coordination_dir=Path(tmp) / "coord",
            dp=train_dp, checkpoint_every=2, step_deadline_s=120.0,
            first_step_deadline_s=600.0,
            placement_exclude=[chips[-1]])
        mgr = ReplicaManager(
            lambda name: ServingEngine(params, cfg, slots=slots,
                                       device=device),
            replicas=1, chip_of=lambda name: chips[-1],
            depth_bound=slots)
        gw = FleetGateway(mgr, queue_capacity=4 * n_requests,
                          auto_replace=False, tenant="hi")
        ledger = ChipLedger(chips)
        registry = TenantRegistry(capacity=len(chips))
        registry.add(TenantSpec("hi", priority=2, quota=len(chips),
                                floor=1), ServingTenant(gw))
        registry.add(TenantSpec("lo", priority=1, quota=gang_chips,
                                floor=0),
                     TrainingTenant(sup, target_dp=train_dp))
        rec = MultiTenantReconciler(
            registry, ledger=ledger,
            packer=TopologyBinPacker(ledger, domain_size=1),
            config=MtConfig(queue_high=3, up_after=1, down_after=2,
                            regrow_after=2, arrival_low_rps=1e9))

        sup.begin(10_000)                      # stopped by the probe
        sup_live = True
        err_samples: list[float] = []

        def pump(sample_err: bool = False):
            nonlocal sup_live
            gw.step()
            if sup_live:
                sup_live = sup.step_once()
            rec.tick()
            if sample_err:
                err_samples.append(rec.fairshare_error())

        def first_event(kind):
            for t, k, info in rec.events:
                if k == kind:
                    return t, info
            return None, None

        # -- phase A: burst against a dry pool --------------------------
        for i in range(n_requests):
            gw.submit(Request(
                uid=f"m{i}",
                prompt=rng.integers(0, vocab, 8).astype(np.int32),
                max_new=max_new), slo_s=slo_s)
        granted: set = set()
        t_served = None
        rounds = 0
        while rounds < max_rounds:
            rounds += 1
            pump(sample_err=True)
            granted = {i["replica"] for _, k, i in rec.events
                       if k == "grant"}
            if granted and t_served is None:
                if any(g.status == "finished" and g.replica in granted
                       for g in gw.outcomes.values()):
                    t_served = time.monotonic()
            if (t_served is not None and not len(gw.queue)
                    and not any(r.in_flight for r in mgr.replicas)):
                break
        t_park, _ = first_event("reclaim_park")

        # -- phase B: calm → release → regrow the parked gang -----------
        t_regrown = None
        while rounds < max_rounds:
            rounds += 1
            pump()
            t_rg, _ = first_event("regrow")
            if (t_rg is not None and sup.dp == train_dp
                    and sup.state == "running"
                    and sup.losses
                    and sup.recoveries
                    and sup.recoveries[-1].cause == "expand"
                    and sup._step > sup.recoveries[-1].restored_step):
                t_regrown = time.monotonic()
                break
        t_rg, _ = first_event("regrow")

        report = sup.report()
        ckpt.close()

    steps = [s for s, _ in report.losses]
    exactly_once = steps == list(range(1, len(steps) + 1))
    finished = sum(1 for g in gw.outcomes.values()
                   if g.status == "finished")
    causes = [r.cause for r in report.recoveries]
    frag = fragmentation_probe()
    fairshare_err = (round(sum(err_samples) / len(err_samples), 4)
                     if err_samples else -1.0)
    valid = (t_park is not None and t_served is not None
             and t_rg is not None and t_regrown is not None
             and finished == n_requests and exactly_once
             and causes == ["park", "expand"]
             and all(r.steps_lost == 0 for r in report.recoveries)
             and report.dp == train_dp
             and frag["frag_win_x"] > 1.0)

    def ms(a, b):
        return round((b - a) * 1000, 1) if None not in (a, b) else -1.0

    return {
        "chips": len(chips),
        "train_dp": train_dp,
        "tp": tp,
        "requests": n_requests,
        "rounds": rounds,
        "preempt_cascade_ms": ms(t_park, t_served),
        "regrow_ms": ms(t_rg, t_regrown),
        "frag_win_x": frag["frag_win_x"],
        "frag": frag,
        "fairshare_err": fairshare_err,
        "train_steps": report.steps,
        "finished": finished,
        "recovery_causes": causes,
        "steps_lost": [r.steps_lost for r in report.recoveries],
        "exactly_once": exactly_once,
        "valid": valid,
        "note": ("two-tenant cascade cycle: hi-priority burst -> park "
                 "the floor-zero gang (checkpoint + full release) -> "
                 "grant freed chips -> serve -> calm release -> "
                 "EXPAND regrow from the parked checkpoint; "
                 "preempt_cascade_ms is park-to-first-served on "
                 "reclaimed chips, frag_win_x is the pure-host packed "
                 "vs naive regrow-width ratio, fairshare_err is mean "
                 "|held-entitled|/entitled over the contention phase"),
    }


__all__ = ["fleet_probe", "fragmentation_probe", "multitenant_probe"]
