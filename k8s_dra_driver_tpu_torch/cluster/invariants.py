"""Always-on fleet invariants: the checkers the crucible runs every
cycle.

The port's copy of ``k8s_dra_driver_tpu/cluster/invariants.py``, over
the port's gateways, gang supervisors and chip ledger.  The promises
every chaos test asserts (exactly-once terminal outcomes, byte-equal
results, monotone loss trajectories, one owner per chip) are stated
ONCE as pure functions over live objects, so the compound-fault soak
(cluster/crucible.py) can evaluate the full set after every co-loop
cycle.  Every violation message is the reference's, word for word.

Design rules:

- Checkers READ, never mutate: no ``take_*`` calls, no stepping, no
  metric increments; a checker that perturbed the rig would make the
  soak's violation log depend on checking frequency.
- Each returns a list of violation strings (empty = invariant holds)
  instead of raising, so the crucible collects ALL breakage of one
  cycle before minimizing.
- Mid-cycle truth only: per-cycle checkers accept transient states
  (queued, in-flight, REFORM) and flag what must NEVER hold even
  transiently; end-of-run checkers (:func:`exactly_once_terminal`,
  :func:`byte_equal`) additionally require completion.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

# terminal gateway statuses (gateway/admission.py) — anything else in
# outcomes is a lifecycle leak
TERMINAL_STATUSES = frozenset({
    "finished", "shed_expired", "rejected_full",
    "rejected_duplicate", "rejected_invalid"})

# reconciler reclaim kinds that carry a beneficiary whose priority
# class must outrank the victim's (fleet/tenancy.py cascade order)
RECLAIM_KINDS = frozenset({"reclaim_park", "reclaim_shrink",
                           "reclaim_drain"})


# -- gateway -----------------------------------------------------------


def gateway_conservation(gw, submitted: int | None = None
                         ) -> list[str]:
    """Request conservation: every admission is terminal, queued, or
    in flight — nothing silently dropped, nothing double-counted.

    ``submitted`` overrides ``gw.admissions_total`` for harnesses that
    track their own submit count (resubmitted uids would legitimately
    skew the gateway counter).  Works against FleetGateway and
    ShardedGateway alike (both expose outcomes/refused/pending and a
    ``manager`` with per-replica in-flight maps).
    """
    violations: list[str] = []
    admitted = (gw.admissions_total if submitted is None
                else submitted)
    terminal = len(gw.outcomes) + len(gw.refused)
    queued = gw.pending() if callable(getattr(gw, "pending", None)) \
        else len(gw.queue)
    in_flight = sum(len(r.in_flight) for r in gw.manager.replicas)
    if admitted != terminal + queued + in_flight:
        violations.append(
            f"request conservation broken: admitted={admitted} != "
            f"terminal={terminal} + queued={queued} + "
            f"in_flight={in_flight}")
    return violations


def terminal_is_final(gw) -> list[str]:
    """A uid with a terminal outcome must not be live anywhere:
    not queued in any pump, not in any replica's in-flight map, and
    its recorded status must be one of the terminal set.  This is the
    per-cycle face of exactly-once — the end-of-run face is
    :func:`exactly_once_terminal`."""
    violations: list[str] = []
    for uid, g in gw.outcomes.items():
        if g.status not in TERMINAL_STATUSES:
            violations.append(
                f"outcome {uid!r} has non-terminal status "
                f"{g.status!r}")
    live: dict = {}
    pumps = getattr(gw, "pumps", None)
    queues = ([p.queue for p in pumps] if pumps is not None
              else [gw.queue])
    for q in queues:
        for uid in q.uids():
            live.setdefault(uid, []).append("queued")
    for r in gw.manager.replicas:
        for uid in r.in_flight:
            live.setdefault(uid, []).append(f"in-flight@{r.name}")
    for uid, where in live.items():
        if uid in gw.outcomes:
            violations.append(
                f"uid {uid!r} is terminal "
                f"({gw.outcomes[uid].status!r}) but still live: "
                f"{', '.join(where)}")
        if len(where) > 1:
            violations.append(
                f"uid {uid!r} live in {len(where)} places at once: "
                f"{', '.join(where)}")
    return violations


def exactly_once_terminal(gw, submitted_uids: Iterable) -> list[str]:
    """End-of-run: every submitted uid reached EXACTLY one terminal
    outcome (the ``outcomes`` dict key-uniqueness plus the
    no-uid-both-finished-and-refused check), and nothing is left
    live."""
    violations = terminal_is_final(gw)
    refused_uids = [g.uid for g in gw.refused]
    seen = set(gw.outcomes)
    for uid in refused_uids:
        if uid in seen:
            violations.append(
                f"uid {uid!r} both refused and terminal in outcomes")
    if len(refused_uids) != len(set(refused_uids)):
        violations.append("duplicate uids in the refused list")
    for uid in submitted_uids:
        n = (uid in seen) + refused_uids.count(uid)
        if n != 1:
            violations.append(
                f"uid {uid!r} reached {n} terminal outcomes "
                f"(want exactly 1)")
    return violations


def _host(x) -> np.ndarray:
    """Token arrays as numpy: tensors (on any device) come to the
    host, anything else goes through ``np.asarray``."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def byte_equal(results: Mapping, oracles: Mapping) -> list[str]:
    """Every finished request's tokens match its single-engine oracle
    bit for bit — recovery may reschedule, never change output.
    Tokens and oracles may be numpy arrays, lists or tensors; the
    comparison is exact."""
    violations: list[str] = []
    for uid, want in oracles.items():
        got = results.get(uid)
        if got is None:
            violations.append(f"uid {uid!r} has no result to compare")
            continue
        tokens = _host(got.tokens)
        want = _host(want)
        if (tokens.shape != want.shape
                or not np.array_equal(tokens, want)):
            violations.append(
                f"uid {uid!r} diverged from oracle: "
                f"got {tokens.tolist()} want "
                f"{want.tolist()}")
    return violations


# -- training gangs ----------------------------------------------------


def losses_exactly_once(losses: Sequence, recoveries: Sequence
                        ) -> list[str]:
    """The loss trajectory advances one step at a time, rewinding
    only where a recovery declared a restore point (to
    ``restored_step + 1``), and each declared rewind is consumed at
    most once.  EVERY recovery contributes a potential rewind, not
    just ``steps_lost > 0`` ones: a second fault landing before the
    first post-restore step completes re-restores the same
    checkpoint with ``steps_lost == 0`` from the supervisor's view,
    yet the replayed step appears in ``losses`` once more — the
    compound-fault shape a single-fault checker misreads as a
    double-count.  ``losses`` is the supervisor's ``(step, loss)``
    list; non-finite losses are violations too."""
    violations: list[str] = []
    rewind_starts = [r.restored_step + 1 for r in recoveries]
    prev = 0
    for step, loss in losses:
        if not np.isfinite(loss):
            violations.append(f"non-finite loss at step {step}")
        if step == prev + 1:
            prev = step
            continue
        if step <= prev and step in rewind_starts:
            rewind_starts.remove(step)
            prev = step
            continue
        violations.append(
            f"step {step} after {prev} is neither contiguous nor a "
            f"declared rewind (open rewinds: {rewind_starts})")
        prev = step
    return violations


def untainted_restores(sup, tainted_steps, gang: str = "gang"
                       ) -> list[str]:
    """No recovery AFTER a corruption event restored the generation
    it tampered with: verify-on-restore (parallel/resharding.py) must
    classify a damaged generation unreadable and fall back, so a
    tampered step appearing as a later recovery's ``restored_step``
    means corrupted bytes reached the training math — the silent-
    wrong-weights resume the checksums exist to prevent.

    ``tainted_steps`` is the injector's ground truth (crucible
    ``tampered``): a mapping of step -> index into ``recoveries`` at
    tampering time (a plain iterable of steps means "tainted from the
    start").  Recoveries BELOW that index restored the generation
    while its bytes were still good — only later ones prove a
    detection failure.  Torn-manifest generations are excluded by the
    injector itself (the supervisor legitimately rewrites them)."""
    violations: list[str] = []
    items = (dict(tainted_steps) if isinstance(tainted_steps, Mapping)
             else {s: 0 for s in tainted_steps})
    recs = list(getattr(sup, "recoveries", []))
    for step, since in items.items():
        for r in recs[since:]:
            if r.restored_step == step:
                violations.append(
                    f"{gang}: recovery ({r.cause!r}) restored "
                    f"tampered generation {step} — corruption went "
                    f"undetected at restore")
    return violations


def placement_fence(sup, gang: str = "gang") -> list[str]:
    """No alive worker runs on a chip the supervisor itself fenced
    off: the dead set and the placement-exclusion set must be
    disjoint from every live worker's chips at all times — including
    mid-REFORM, which is exactly where a second fault lands."""
    violations: list[str] = []
    fence = (set(getattr(sup, "_dead_chips", ()))
             | set(getattr(sup, "_placement_excluded", ())))
    for w in getattr(sup, "workers", []):
        if not getattr(w, "alive", False):
            continue
        overlap = set(w.chips) & fence
        if overlap:
            violations.append(
                f"{gang}: alive worker {w.name} occupies fenced "
                f"chips {sorted(overlap)} "
                f"(dead={sorted(getattr(sup, '_dead_chips', ()))}, "
                f"excluded="
                f"{sorted(getattr(sup, '_placement_excluded', ()))})")
    return violations


# -- chip ledger -------------------------------------------------------


def ledger_conservation(ledger, records) -> list[str]:
    """Every chip is owned by at most ONE holder across the whole
    fleet, recomputed from the subsystems' own records (live replicas
    pin chips; alive gang workers own theirs) — the ledger's owner
    map is a cache, the workloads are the truth.  ``records`` is the
    ``sync_multi`` iterable: ``(tenant, manager_or_None,
    supervisor_or_None)`` triples."""
    violations: list[str] = []
    holders: dict[int, list[str]] = {}
    known = set(ledger.chips)
    for tenant, manager, sup in records:
        if manager is not None:
            for r in manager.replicas:
                if r.state != "dead" and r.chip is not None:
                    holders.setdefault(int(r.chip), []).append(
                        f"serving:{tenant}:{r.name}")
        if sup is not None:
            for w in getattr(sup, "workers", []):
                if not getattr(w, "alive", False):
                    continue
                for c in w.chips:
                    holders.setdefault(int(c), []).append(
                        f"training:{tenant}:{w.name}")
    for chip, who in sorted(holders.items()):
        if len(who) > 1:
            violations.append(
                f"chip {chip} owned by {len(who)} holders at once: "
                f"{', '.join(who)}")
        if chip not in known:
            violations.append(
                f"chip {chip} held by {who[0]} is outside the "
                f"ledger's supply {sorted(known)}")
    return violations


def quota_respected(ledger, specs) -> list[str]:
    """No tenant holds more chips than its quota.  Reads the ledger's
    synced multi-tenant owner tags (fleet/supply.py ``sync_multi``),
    so run it after the reconciler's tick resynced ownership."""
    from ..fleet.supply import owner_tenant
    violations: list[str] = []
    held: dict[str, int] = {}
    for c in ledger.chips:
        t = owner_tenant(ledger.owners.get(c))
        if t is not None:
            held[t] = held.get(t, 0) + 1
    for s in specs:
        if held.get(s.name, 0) > s.quota:
            violations.append(
                f"tenant {s.name} holds {held[s.name]} chips over "
                f"quota {s.quota}")
    return violations


def reclaim_priority_order(specs, events) -> list[str]:
    """Every reclaim event names a beneficiary whose priority class
    strictly outranks the victim's — the cascade never takes from an
    equal or higher class (fleet/tenancy.py ``_reclaim_for``).
    ``events`` is the reconciler's ``(t, kind, info)`` log."""
    violations: list[str] = []
    prio = {s.name: s.priority for s in specs}
    for t, kind, info in events:
        if kind not in RECLAIM_KINDS:
            continue
        victim = info.get("tenant")
        claimant = info.get("beneficiary")
        if victim is None or claimant is None:
            violations.append(
                f"reclaim event {kind!r} at t={t} lacks "
                f"victim/beneficiary: {info}")
            continue
        if prio.get(victim, 0) >= prio.get(claimant, 0):
            violations.append(
                f"reclaim order broken at t={t}: {kind} took from "
                f"{victim} (class {prio.get(victim)}) for "
                f"{claimant} (class {prio.get(claimant)})")
    return violations


# -- the full per-cycle sweep -----------------------------------------


def check_cycle(*, gateways=(), supervisors=(), ledger=None,
                records=None, specs=None, events=(),
                submitted: Mapping | None = None,
                tainted: Mapping | None = None) -> list[str]:
    """One cycle's full sweep: every per-cycle checker over every
    subsystem the rig composes.  ``gateways``/``supervisors`` are
    ``(name, obj)`` pairs so violations say WHO broke; ``submitted``
    maps gateway name -> submit count (see
    :func:`gateway_conservation`); ``tainted`` maps gang name -> the
    steps a corruption injector tampered with
    (:func:`untainted_restores`).  End-of-run checkers
    (exactly-once, byte-equal) are deliberately absent — the crucible
    runs those once at the end, when completion is actually owed."""
    violations: list[str] = []
    for name, gw in gateways:
        n = None if submitted is None else submitted.get(name)
        violations += [f"[{name}] {v}"
                       for v in gateway_conservation(gw, n)]
        violations += [f"[{name}] {v}" for v in terminal_is_final(gw)]
    for name, sup in supervisors:
        violations += placement_fence(sup, gang=name)
        violations += [f"[{name}] {v}" for v in losses_exactly_once(
            sup.losses, sup.recoveries)]
        if tainted is not None:
            violations += untainted_restores(
                sup, tainted.get(name, ()), gang=name)
    if ledger is not None and records is not None:
        violations += ledger_conservation(ledger, records)
    if ledger is not None and specs is not None:
        violations += quota_respected(ledger, specs)
    if specs is not None:
        violations += reclaim_priority_order(specs, events)
    return violations


__all__ = ["TERMINAL_STATUSES", "RECLAIM_KINDS",
           "gateway_conservation", "terminal_is_final",
           "exactly_once_terminal", "byte_equal",
           "losses_exactly_once", "placement_fence",
           "untainted_restores",
           "ledger_conservation", "quota_respected",
           "reclaim_priority_order", "check_cycle"]
