"""Topology bin-packing for k concurrent chip owners.

The port's copy of ``k8s_dra_driver_tpu/fleet/binpack.py``, pure host
logic.  The 1x1 fleet keeps fragmentation at bay with two conventions
— gang from the HEAD of the ledger order, serving from the TAIL — which
stop working the moment a second gang or a second pool exists: k owners
interleaving first-fit allocations shred the ledger order into
single-chip holes, and a victim tenant that later frees its chips hands
back confetti instead of a regrow block.  This module is the placement
brain the multi-tenant reconciler (fleet/tenancy.py) asks "WHICH
chip/run", with two ideas:

- **Link domains as overlap tokens.**  The ledger order (the
  interconnect's) is partitioned into fixed **link domains** of
  ``domain_size`` adjacent chips, and a domain is a token at most ONE
  tenant may hold.  A placement whose domains contain another
  tenant's chip is a conflict: two tenants never straddle the same
  link domain, and a freed tenant always frees whole domains.
- **Anti-fragmentation scoring.**  Among conflict-free candidates,
  prefer placements that keep each tenant's chips dense (fill a
  domain the tenant already holds, pack next to its own block) and
  far from OTHER tenants' blocks — the farther a new allocation lands
  from a victim gang, the wider that gang's future contiguous regrow.

``naive_first_fit`` is the strawman the fragmentation probe
(fleet/probe.py) compares against: lowest-index free chip, no domain
or distance awareness.
"""

from __future__ import annotations

import bisect
import dataclasses

from .supply import ChipLedger, owner_tenant


@dataclasses.dataclass(frozen=True)
class Placement:
    """One placement decision: the chips (in ledger order) and the
    link domains the run touches."""

    chips: tuple
    domains: tuple


class TopologyBinPacker:
    """Placement scoring over a :class:`~.supply.ChipLedger` whose
    owners were synced via ``sync_multi`` (tenant-qualified tags).

    ``domain_size`` chips per link domain, counted in LEDGER order
    (position, not chip id — ledger order is interconnect order).  All methods
    are pure reads over the ledger's current owners/health; the
    caller claims what it actuates.
    """

    def __init__(self, ledger: ChipLedger, *, domain_size: int = 2):
        if domain_size < 1:
            raise ValueError("domain_size must be >= 1")
        self.ledger = ledger
        self.domain_size = domain_size
        self._pos = {c: i for i, c in enumerate(ledger.chips)}

    # -- domains ---------------------------------------------------------

    def domain_of(self, chip: int) -> int:
        return self._pos[chip] // self.domain_size

    def domain_chips(self, domain: int) -> list[int]:
        lo = domain * self.domain_size
        return self.ledger.chips[lo:lo + self.domain_size]

    def conflict_table(self) -> dict[int, set]:
        """domain -> set of tenants currently holding chips in it.
        The overlap-token view: any domain with more than one tenant
        is a straddle (the invariant the packer exists to prevent);
        a domain with exactly one is that tenant's token."""
        table: dict[int, set] = {}
        for c in self.ledger.chips:
            t = owner_tenant(self.ledger.owners.get(c))
            if t is not None:
                table.setdefault(self.domain_of(c), set()).add(t)
        return table

    def _conflicts(self, chips, tenant: str) -> bool:
        """Would ``tenant`` taking ``chips`` straddle a domain that
        holds another tenant's chip?"""
        table = self.conflict_table()
        for c in chips:
            holders = table.get(self.domain_of(c), set())
            if holders - {tenant}:
                return True
        return False

    # -- candidate sets --------------------------------------------------

    def _free_healthy(self) -> list[int]:
        return self.ledger.healthy_free()

    def _tenant_chips(self, tenant: str) -> list[int]:
        return [c for c in self.ledger.chips
                if owner_tenant(self.ledger.owners.get(c)) == tenant]

    def _other_chips(self, tenant: str) -> list[int]:
        return [c for c in self.ledger.chips
                if owner_tenant(self.ledger.owners.get(c))
                not in (None, tenant)]

    @staticmethod
    def _min_dist(pos, positions) -> int:
        if not positions:
            return 0
        return min(abs(pos - p) for p in positions)

    @staticmethod
    def _min_dist_sorted(pos, positions) -> int:
        """:meth:`_min_dist` over an already-SORTED position list —
        bisect instead of a linear scan, so a thousand-chip fleet
        scores a candidate in O(log n).  Identical values by
        construction)."""
        if not positions:
            return 0
        i = bisect.bisect_left(positions, pos)
        best = None
        if i < len(positions):
            best = positions[i] - pos
        if i > 0:
            d = pos - positions[i - 1]
            best = d if best is None else min(best, d)
        return best

    # -- single-chip placement (serving replicas) ------------------------

    def place_chip(self, tenant: str) -> int | None:
        """Best free healthy chip for one more ``tenant`` replica, or
        None when every candidate is gone or domain-conflicted.

        Score (lexicographic): fill a domain the tenant already
        partially holds; then land as FAR from other tenants' chips
        as possible (their regrow blocks stay wide); then as NEAR the
        tenant's own chips as possible (dense); then highest index
        (the serving-from-the-tail convention as the final tie).

        The conflict table is computed ONCE per call and distances go
        through sorted-position bisect — at fleet scale the per-
        candidate table rebuild made this O(chips^2) per placement;
        same decisions)."""
        own = sorted(self._pos[c] for c in self._tenant_chips(tenant))
        own_domains = {p // self.domain_size for p in own}
        others = sorted(self._pos[c]
                        for c in self._other_chips(tenant))
        table = self.conflict_table()
        best, best_key = None, None
        for c in self._free_healthy():
            p = self._pos[c]
            holders = table.get(p // self.domain_size, set())
            if holders - {tenant}:
                continue
            key = (p // self.domain_size in own_domains,
                   self._min_dist_sorted(p, others),
                   -self._min_dist_sorted(p, own) if own else 0,
                   p)
            if best_key is None or key > best_key:
                best, best_key = c, key
        return best

    # -- contiguous-run placement (gang homes) ---------------------------

    def place_run(self, tenant: str, n: int, *,
                  usable_owner: str | None = None) -> Placement | None:
        """Best contiguous run of ``n`` chips that are healthy and
        free — or owned by ``usable_owner`` (the tenant's own training
        tag: a gang re-forms from scratch, so its chips count toward
        its own regrow block, exactly the 1x1
        ``contiguous_available`` rule).  None when no conflict-free
        run exists.

        Score: maximize overlap with the tenant's current chips (a
        regrow should extend the block, not relocate it), then leave
        the largest remaining free run (future allocations — anyone's
        — stay unfragmented), then lowest start (the gang-from-the-
        head convention as the final tie)."""
        chips = self.ledger.chips
        usable = []
        for c in chips:
            owner = self.ledger.owners.get(c)
            ok = (c not in self.ledger.unhealthy
                  and (owner is None
                       or (usable_owner is not None
                           and owner == usable_owner)))
            usable.append(ok)
        own = set(self._tenant_chips(tenant))
        # Hoisted per-call state so each window scores in O(1): the
        # naive form recomputed the conflict table and rescanned the
        # whole ledger for the largest free run PER WINDOW — O(chips^2)
        # per placement, which the thousand-chip sim fleet cannot
        # afford.  Same keys, same winner (equivalence-pinned).
        table = self.conflict_table()
        n_dom = (len(chips) + self.domain_size - 1) // self.domain_size
        bad_dom = [1 if table.get(d, set()) - {tenant} else 0
                   for d in range(n_dom)]
        bad_pref = [0]
        for b in bad_dom:
            bad_pref.append(bad_pref[-1] + b)
        usable_pref = [0]
        for u in usable:
            usable_pref.append(usable_pref[-1] + (1 if u else 0))
        own_pref = [0]
        for c in chips:
            own_pref.append(own_pref[-1] + (1 if c in own else 0))
        free = [self.ledger.owners.get(c) is None
                and c not in self.ledger.unhealthy for c in chips]
        segs = self._free_segments(free)
        seg_starts = [s for s, _ in segs]
        seg_ends = [e for _, e in segs]
        # prefix/suffix maxima of segment lengths, so "largest free
        # run outside a contiguous window" is a range-max query
        pre_max = [0] * (len(segs) + 1)
        for i, (s, e) in enumerate(segs):
            pre_max[i + 1] = max(pre_max[i], e - s + 1)
        suf_max = [0] * (len(segs) + 1)
        for i in range(len(segs) - 1, -1, -1):
            s, e = segs[i]
            suf_max[i] = max(suf_max[i + 1], e - s + 1)
        best, best_key = None, None
        for start in range(len(chips) - n + 1):
            if usable_pref[start + n] - usable_pref[start] != n:
                continue
            dlo = start // self.domain_size
            dhi = (start + n - 1) // self.domain_size
            if bad_pref[dhi + 1] - bad_pref[dlo]:
                continue
            remaining = self._largest_free_run_excluding(
                segs, seg_starts, seg_ends, pre_max, suf_max, start,
                start + n - 1)
            key = (own_pref[start + n] - own_pref[start], remaining,
                   -start)
            if best_key is None or key > best_key:
                window = chips[start:start + n]
                domains = tuple(sorted({self.domain_of(c)
                                        for c in window}))
                best = Placement(chips=tuple(window), domains=domains)
                best_key = key
        return best

    @staticmethod
    def _free_segments(free) -> list[tuple[int, int]]:
        """Maximal runs of free positions as inclusive (start, end)
        index pairs."""
        segs: list[tuple[int, int]] = []
        run_start = None
        for i, ok in enumerate(free):
            if ok and run_start is None:
                run_start = i
            elif not ok and run_start is not None:
                segs.append((run_start, i - 1))
                run_start = None
        if run_start is not None:
            segs.append((run_start, len(free) - 1))
        return segs

    @staticmethod
    def _largest_free_run_excluding(segs, seg_starts, seg_ends,
                                    pre_max, suf_max, lo, hi) -> int:
        """Largest free run with positions [lo, hi] carved out —
        equal by construction to rescanning the ledger with those
        positions excluded (``_largest_free_run(exclude=window)``),
        because a window only trims or splits the segments it
        overlaps and a contiguous window overlaps a contiguous
        segment range."""
        if not segs:
            return 0
        # first segment whose END reaches lo, last whose START <= hi
        i = bisect.bisect_left(seg_ends, lo)
        j = bisect.bisect_right(seg_starts, hi) - 1
        if i > j:                   # window misses every segment
            return max(pre_max[-1], 0)
        best = max(pre_max[i], suf_max[j + 1])
        s, _ = segs[i]
        if lo > s:                  # left remnant of first overlap
            best = max(best, lo - s)
        _, e = segs[j]
        if hi < e:                  # right remnant of last overlap
            best = max(best, e - hi)
        return best

    def _largest_free_run(self, exclude=frozenset()) -> int:
        best = run = 0
        for c in self.ledger.chips:
            if (self.ledger.owners.get(c) is None
                    and c not in self.ledger.unhealthy
                    and c not in exclude):
                run += 1
                best = max(best, run)
            else:
                run = 0
        return best

    def regrow_width(self, tenant: str, *, tp: int = 1,
                     target_dp: int = 1) -> int:
        """Largest power-of-two dp ≤ ``target_dp`` whose ``dp*tp``
        chips have a conflict-free contiguous home counting the
        tenant's own training chips; 0 when nothing fits."""
        from .supply import training_tag
        best, dp = 0, 1
        while dp <= target_dp:
            if self.place_run(tenant, dp * tp,
                              usable_owner=training_tag(tenant)):
                best = dp
            dp *= 2
        return best

    # -- the strawman ----------------------------------------------------

    def naive_first_fit(self, n: int = 1) -> list[int]:
        """Lowest-index free healthy chips, no domain or distance
        awareness — the 1x1-convention baseline the fragmentation
        probe scores the packer against."""
        return self._free_healthy()[:n]


__all__ = ["Placement", "TopologyBinPacker"]
