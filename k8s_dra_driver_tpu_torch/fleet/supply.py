"""Chip supply ledger: who owns which chip, and what is free.

The port's copy of ``k8s_dra_driver_tpu/fleet/supply.py``: the
reconciler's supply half, pure host logic.  The workload layer needs
"which devices can this take" answered CONTINUOUSLY over one node's
chips: which are healthy, which back a serving replica, which the
training gang holds, and whether a candidate gang width has a
contiguous home.  The ledger's order is the interconnect's (the chip
labels a caller hands it, in adjacency order), so contiguity in ledger
order is contiguity on the interconnect.  The labels are allocation
labels: several may name replicas that live on one card.

Two conventions keep serving and training from fragmenting each other:

- the gang forms from the HEAD of the ledger order (``job.build``
  takes the first ``dp*tp`` surviving devices), and
- serving takes chips from the TAIL (:meth:`ChipLedger.take_for_serving`
  returns the LAST free healthy chip),

so after any sequence of preempts and scale-ups the free chips sit in
one block between the two, and a regrow check is a contiguous-run scan
instead of a packing problem.

Health follows the driver's health-monitor contract: a failed probe keeps the
last observed state (neither mass-freeing chips nor forgetting
known-bad ones), and heals are REMEMBERED until the reconciler
forwards them (``take_healed``) — the chip up-signal must reach the
supervisor's exclusion set exactly once, not once per tick.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

log = logging.getLogger(__name__)

# ownership classes the ledger reports (the gauge labels in
# utils/metrics.py FleetMetrics)
TRAINING = "training"


def training_tag(tenant: str) -> str:
    """Multi-tenant training owner tag (``sync_multi``)."""
    return f"training:{tenant}"


def serving_tag(tenant: str, replica: str) -> str:
    """Multi-tenant serving owner tag (``sync_multi``)."""
    return f"serving:{tenant}:{replica}"


def owner_tenant(owner: str | None) -> str | None:
    """The tenant a multi-tenant owner tag belongs to, or None for a
    free chip.  Only meaningful on ledgers synced via ``sync_multi``
    (the 1x1 ``sync`` tags carry no tenant segment)."""
    if not owner:
        return None
    parts = owner.split(":")
    if len(parts) >= 2 and parts[0] in ("serving", TRAINING):
        return parts[1]
    return None


@dataclasses.dataclass(frozen=True)
class SupplyView:
    """One tick's supply snapshot, in ledger order."""

    free: tuple                 # healthy, unowned
    serving: tuple              # owned by a live replica
    training: tuple             # owned by a live gang worker
    unhealthy: dict             # chip -> reason (ownership-agnostic)
    largest_free_block: int     # longest contiguous healthy free run


class ChipLedger:
    """Tracks chip ownership + health for the fleet reconciler.

    ``chips`` is the node's chip set in interconnect order;
    ``health_source`` is the same zero-arg ``{chip: reason}`` callable
    the rest of the health stack shares (a discovery backend's bound
    ``health()``, or a test dict's ``.copy``).  Ownership is never cached across ticks: ``sync``
    recomputes it from the replica pool and the gang's own worker
    records, the two places that actually know.
    """

    def __init__(self, chips, health_source: Callable[[], dict]
                 | None = None):
        self.chips = [int(c) for c in chips]
        self.owners: dict[int, str | None] = {c: None
                                              for c in self.chips}
        self.health_source = health_source
        self.unhealthy: dict[int, str] = {}
        self._healed: set[int] = set()

    @classmethod
    def from_backend(cls, backend) -> "ChipLedger":
        """Ledger over a discovery backend's chip set, in index order,
        with its ``health()`` bound as the health source.  Duck-typed:
        ``backend.enumerate().chips`` carry ``index``, and
        ``backend.health(expected=...)`` answers ``{chip: reason}``.
        The boot-time expected set rides along, so a chip whose entry
        vanishes entirely still reads unhealthy."""
        topology = backend.enumerate()
        chips = sorted(c.index for c in topology.chips)
        expected = frozenset(chips)
        return cls(chips, health_source=lambda: backend.health(
            expected=expected))

    # -- health ----------------------------------------------------------

    def observe_health(self) -> None:
        """Poll the health source; keep-last-state on probe failure
        (the health-monitor contract).  Chips that left the
        unhealthy set are queued for ``take_healed``."""
        if self.health_source is None:
            return
        try:
            now = {int(k): v for k, v in
                   (self.health_source() or {}).items()}
        except Exception:
            log.exception("ledger health probe failed; keeping last")
            return
        self._apply_health(now)

    def on_health(self, unhealthy: dict) -> None:
        """Health-monitor listener signature — the push twin of
        :meth:`observe_health`; attach via ``monitor.listeners``."""
        self._apply_health({int(k): v for k, v in unhealthy.items()})

    def _apply_health(self, now: dict[int, str]) -> None:
        self._healed |= set(self.unhealthy) - set(now)
        self._healed -= set(now)
        self.unhealthy = now

    def take_healed(self) -> set[int]:
        """Chips that recovered since the last call — consumed, so the
        up-signal is forwarded exactly once."""
        healed, self._healed = self._healed, set()
        return healed

    def current_unhealthy(self) -> dict[int, str]:
        """The last observed unhealthy view — the ``health_source``
        the replica pool polls, so the gateway pump and the reconciler
        judge chips from ONE observation instead of racing two."""
        return dict(self.unhealthy)

    # -- ownership -------------------------------------------------------

    def sync(self, manager=None, supervisor=None) -> None:
        """Recompute ownership from the subsystems' own records: live
        (non-dead) replicas own their pinned chips, alive gang workers
        own theirs.  A chip the ledger does not track is ignored —
        supply is whatever the operator handed the ledger."""
        for c in self.chips:
            self.owners[c] = None
        if manager is not None:
            for r in manager.replicas:
                if r.state != "dead" and r.chip in self.owners:
                    self.owners[r.chip] = f"serving:{r.name}"
        if supervisor is not None:
            for w in getattr(supervisor, "workers", []):
                if not w.alive:
                    continue
                for c in w.chips:
                    if c in self.owners:
                        self.owners[c] = TRAINING

    def sync_multi(self, records) -> None:
        """The k-tenant twin of :meth:`sync`: ``records`` is an
        iterable of ``(tenant, manager_or_None, supervisor_or_None)``
        triples and owner tags become tenant-qualified
        (``serving:{tenant}:{replica}`` / ``training:{tenant}``, see
        :func:`owner_tenant`) so the bin-packer's overlap-token
        conflict table (fleet/binpack.py) can tell WHOSE chip sits in
        a link domain, not just that one does."""
        for c in self.chips:
            self.owners[c] = None
        for tenant, manager, supervisor in records:
            if manager is not None:
                for r in manager.replicas:
                    if r.state != "dead" and r.chip in self.owners:
                        self.owners[r.chip] = serving_tag(tenant,
                                                          r.name)
            if supervisor is not None:
                for w in getattr(supervisor, "workers", []):
                    if not w.alive:
                        continue
                    for c in w.chips:
                        if c in self.owners:
                            self.owners[c] = training_tag(tenant)

    def claim(self, chip: int, owner: str) -> None:
        """Claim a specific chip for ``owner`` immediately — the
        multi-tenant twin of :meth:`take_for_serving`'s pending claim,
        used after the bin-packer picked WHICH chip: two decisions in
        one tick can never double-book it."""
        if self.owners.get(chip) is not None:
            raise ValueError(f"chip {chip} already owned by "
                             f"{self.owners[chip]}")
        self.owners[chip] = owner

    def healthy_free(self) -> list[int]:
        return [c for c in self.chips
                if self.owners[c] is None and c not in self.unhealthy]

    def take_for_serving(self) -> int | None:
        """The LAST free healthy chip in ledger order (see module
        docstring: serving grows from the tail, the gang from the
        head) — claimed immediately so two decisions in one tick can
        never double-book it."""
        free = self.healthy_free()
        if not free:
            return None
        chip = free[-1]
        self.owners[chip] = "serving:pending"
        return chip

    def contiguous_available(self, n: int,
                             include: str = TRAINING) -> bool:
        """Is there a run of ``n`` ledger-adjacent healthy chips that
        are free or owned by ``include``?  The gang re-forms from
        scratch, so its own chips count toward its regrow block — the
        question is whether gang ∪ free contains a contiguous
        home of the target width."""
        run = 0
        for c in self.chips:
            owner = self.owners[c]
            ok = (c not in self.unhealthy
                  and (owner is None or owner == include))
            run = run + 1 if ok else 0
            if run >= n:
                return True
        return False

    def view(self) -> SupplyView:
        free, serving, training = [], [], []
        best = run = 0
        for c in self.chips:
            owner = self.owners[c]
            if owner is None and c not in self.unhealthy:
                free.append(c)
                run += 1
                best = max(best, run)
            else:
                run = 0
            if owner == TRAINING:
                training.append(c)
            elif owner is not None:
                serving.append(c)
        return SupplyView(free=tuple(free), serving=tuple(serving),
                          training=tuple(training),
                          unhealthy=dict(self.unhealthy),
                          largest_free_block=best)


__all__ = ["ChipLedger", "SupplyView", "TRAINING", "owner_tenant",
           "serving_tag", "training_tag"]
