"""Cluster-side object kinds beyond the resource API.

The port's copy of ``k8s_dra_driver_tpu/cluster/objects.py``.

Minimal Node / Deployment / Pod records: enough surface for the slice
controller (Node label watch — reference cmd/nvidia-dra-controller/
imex.go:217-305) and the coordinator-daemon manager (Deployment
lifecycle — reference cmd/nvidia-dra-plugin/sharing.go:124-403).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..api.resource import ObjectMeta


@dataclasses.dataclass
class Node:
    metadata: ObjectMeta
    ready: bool = True
    # Full wire object as last read from a real API server; updates
    # merge into this so unmodeled fields (spec.podCIDR, taints, …)
    # survive the round-trip instead of being wiped by a sparse PUT.
    raw: dict[str, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)


@dataclasses.dataclass
class Deployment:
    metadata: ObjectMeta
    spec: dict[str, Any] = dataclasses.field(default_factory=dict)
    ready_replicas: int = 0
    replicas: int = 1
    raw: dict[str, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def ready(self) -> bool:
        return self.ready_replicas >= self.replicas


@dataclasses.dataclass
class Pod:
    metadata: ObjectMeta
    spec: dict[str, Any] = dataclasses.field(default_factory=dict)
    node_name: str = ""
    phase: str = "Pending"
    raw: dict[str, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
