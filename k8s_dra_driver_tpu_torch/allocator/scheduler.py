"""Mini-scheduler: drives the Allocator against a cluster client.

The port's copy of ``k8s_dra_driver_tpu/allocator/scheduler.py``.

The stand-in for kube-scheduler's DRA plugin in hermetic and standalone
deployments: reads published ResourceSlices, DeviceClasses, Nodes and
already-allocated claims, computes an allocation for one claim, and
writes it into ``claim.status.allocation`` — the L4 boundary contract of
SURVEY §3.2.
"""

from __future__ import annotations

from ..api import resource
from ..cluster import ClusterClient
from .allocator import AllocationError, Allocator


def allocate_claim(client: ClusterClient,
                   claim: resource.ResourceClaim,
                   allocator: Allocator | None = None
                   ) -> resource.ResourceClaim:
    """Allocate ``claim`` in-place and persist it. Idempotent."""
    if claim.status.allocation is not None:
        return claim
    allocator = allocator or Allocator()
    slices = client.list("ResourceSlice")
    classes = {c.metadata.name: c for c in client.list("DeviceClass")}
    nodes = client.list("Node")
    allocated = [c for c in client.list("ResourceClaim")
                 if c.status.allocation is not None]
    claim.status.allocation = allocator.allocate(
        claim, slices, classes, nodes=nodes, allocated_claims=allocated)
    client.update(claim)
    return claim


def deallocate_claim(client: ClusterClient,
                     claim: resource.ResourceClaim) -> None:
    claim.status.allocation = None
    claim.status.reserved_for = []
    client.update(claim)


__all__ = ["AllocationError", "Allocator", "allocate_claim",
           "deallocate_claim"]
