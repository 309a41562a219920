"""Fleet probes.

The port's part of ``k8s_dra_driver_tpu/fleet/probe.py``:
``fragmentation_probe``, pure host logic over the bin-packer and the
chip ledger.  ``fleet_probe`` and ``multitenant_probe`` drive elastic
training gangs (the gang supervisor) beside the serving pools, and come
with the supervisor.
"""

from __future__ import annotations


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


__all__ = ["fragmentation_probe"]
