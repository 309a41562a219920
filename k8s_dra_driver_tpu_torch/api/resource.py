"""Isolated Kubernetes resource API surface (resource.k8s.io analog).

The port's copy of ``k8s_dra_driver_tpu/api/resource.py``.

The reference vendors the whole of k8s.io/api + apimachinery; SURVEY §7
("hard parts") calls out API-version churn and recommends isolating the
API surface behind one package — this is that package.  It defines the
minimal structured-parameters vocabulary the driver, controller and
in-repo allocator need: Device/ResourceSlice (what nodes publish),
DeviceClass (admin-defined selection), ResourceClaim (user request +
allocation status).  Objects round-trip to plain-dict JSON/YAML with the
same field names as upstream resource.k8s.io/v1alpha3, so manifests are
interchangeable; nothing imports a Kubernetes client.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

_uid_counter = itertools.count(1)


def _new_uid() -> str:
    return f"uid-{next(_uid_counter):08d}"


@dataclasses.dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = dataclasses.field(default_factory=_new_uid)
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)
    owner_references: list[OwnerReference] = dataclasses.field(default_factory=list)
    resource_version: int = 0


@dataclasses.dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""


# --------------------------------------------------------------------------
# Devices & ResourceSlices (node → scheduler direction)
# --------------------------------------------------------------------------

# Attribute values are typed: string | int | bool | version-string.
AttrValue = str | int | bool


@dataclasses.dataclass
class Device:
    """One allocatable device as the scheduler sees it.

    ``capacity`` values are plain ints (bytes for memory, 1 for slots).
    Devices in the same pool may declare *overlapping* capacity token
    names (e.g. ``chipSlot0``); the allocator treats equal-named tokens
    within a pool as drawn from one shared counter, which is how
    ICI-slice/partition overlap is made scheduler-enforceable — the MIG
    memorySlice technique (reference
    cmd/nvidia-dra-plugin/deviceinfo.go:195-198) generalized.
    """

    name: str
    attributes: dict[str, AttrValue] = dataclasses.field(default_factory=dict)
    capacity: dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ResourcePool:
    name: str
    generation: int = 1
    resource_slice_count: int = 1


@dataclasses.dataclass
class ResourceSlice:
    metadata: ObjectMeta
    driver: str = ""
    pool: ResourcePool = dataclasses.field(
        default_factory=lambda: ResourcePool(name=""))
    node_name: str = ""                      # per-node pool...
    node_selector: dict[str, str] | None = None  # ...or label-selected nodes
    all_nodes: bool = False                  # ...or cluster-wide
    devices: list[Device] = dataclasses.field(default_factory=list)


# --------------------------------------------------------------------------
# DeviceClass (admin → scheduler direction)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceSelector:
    """A CEL selector over device attributes/capacity.

    ``cel`` is the expression string; upstream wire format nests it as
    ``{"cel": {"expression": "..."}}``, which is accepted on input.
    """

    cel: str = ""

    def __post_init__(self):
        if isinstance(self.cel, dict):
            self.cel = self.cel.get("expression", "")


@dataclasses.dataclass
class OpaqueConfig:
    """Driver-opaque configuration passed through allocation verbatim."""

    driver: str = ""
    parameters: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DeviceClassConfig:
    opaque: OpaqueConfig | None = None


@dataclasses.dataclass
class DeviceClass:
    metadata: ObjectMeta
    selectors: list[DeviceSelector] = dataclasses.field(default_factory=list)
    config: list[DeviceClassConfig] = dataclasses.field(default_factory=list)


# --------------------------------------------------------------------------
# ResourceClaim (user → scheduler → driver direction)
# --------------------------------------------------------------------------

ALLOCATION_MODE_EXACT = "ExactCount"
ALLOCATION_MODE_ALL = "All"


@dataclasses.dataclass
class DeviceRequest:
    name: str
    device_class_name: str = ""
    selectors: list[DeviceSelector] = dataclasses.field(default_factory=list)
    allocation_mode: str = ALLOCATION_MODE_EXACT
    count: int = 1


@dataclasses.dataclass
class DeviceConstraint:
    """Cross-request constraint: all matched devices must agree on an
    attribute (e.g. every partition on the same parent chip, every slice
    member on the same host) — the gpu-test4 ``matchAttribute:
    parentUUID`` pattern (reference demo/specs/quickstart/gpu-test4.yaml:42-44).
    """

    requests: list[str] = dataclasses.field(default_factory=list)  # [] = all
    match_attribute: str = ""


@dataclasses.dataclass
class ClaimConfig:
    """Per-claim opaque config, optionally scoped to specific requests."""

    requests: list[str] = dataclasses.field(default_factory=list)  # [] = all
    opaque: OpaqueConfig | None = None


@dataclasses.dataclass
class DeviceClaim:
    requests: list[DeviceRequest] = dataclasses.field(default_factory=list)
    constraints: list[DeviceConstraint] = dataclasses.field(default_factory=list)
    config: list[ClaimConfig] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ResourceClaimSpec:
    devices: DeviceClaim = dataclasses.field(default_factory=DeviceClaim)


CONFIG_SOURCE_CLASS = "FromClass"
CONFIG_SOURCE_CLAIM = "FromClaim"


@dataclasses.dataclass
class AllocatedDeviceConfig:
    source: str = CONFIG_SOURCE_CLAIM
    requests: list[str] = dataclasses.field(default_factory=list)
    opaque: OpaqueConfig | None = None


@dataclasses.dataclass
class DeviceRequestAllocationResult:
    request: str = ""
    driver: str = ""
    pool: str = ""
    device: str = ""


@dataclasses.dataclass
class AllocationResult:
    results: list[DeviceRequestAllocationResult] = dataclasses.field(
        default_factory=list)
    config: list[AllocatedDeviceConfig] = dataclasses.field(default_factory=list)
    node_selector: dict[str, str] | None = None


@dataclasses.dataclass
class ResourceClaimStatus:
    allocation: AllocationResult | None = None
    reserved_for: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ResourceClaim:
    metadata: ObjectMeta
    spec: ResourceClaimSpec = dataclasses.field(default_factory=ResourceClaimSpec)
    status: ResourceClaimStatus = dataclasses.field(
        default_factory=ResourceClaimStatus)


# --------------------------------------------------------------------------
# dict <-> object conversion (camelCase JSON, upstream field names)
# --------------------------------------------------------------------------

def _camel(s: str) -> str:
    head, *rest = s.split("_")
    return head + "".join(w.capitalize() for w in rest)


def to_dict(obj: Any) -> Any:
    """Serialize any of the dataclasses above to a JSON-able dict,
    dropping empty/None fields and camelCasing names."""
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            v = to_dict(getattr(obj, f.name))
            if v in (None, [], {}, "", False, 0) and f.name not in ("count",):
                continue
            out[_camel(f.name)] = v
        return out
    if isinstance(obj, list):
        return [to_dict(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


def _snake(s: str) -> str:
    out = []
    for ch in s:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def from_dict(cls: type, data: dict[str, Any]) -> Any:
    """Inverse of :func:`to_dict` for the dataclasses above."""
    if data is None:
        return None
    kwargs: dict[str, Any] = {}
    hints = {f.name: f.type for f in dataclasses.fields(cls)}
    nested = _NESTED.get(cls, {})
    for key, value in data.items():
        name = _snake(key)
        if name not in hints:
            continue
        if name in nested and value is not None:
            sub, is_list = nested[name]
            if is_list:
                value = [from_dict(sub, v) for v in value]
            else:
                value = from_dict(sub, value)
        kwargs[name] = value
    return cls(**kwargs)


_NESTED: dict[type, dict[str, tuple[type, bool]]] = {
    ObjectMeta: {"owner_references": (OwnerReference, True)},
    ResourceSlice: {"metadata": (ObjectMeta, False),
                    "pool": (ResourcePool, False),
                    "devices": (Device, True)},
    DeviceClass: {"metadata": (ObjectMeta, False),
                  "selectors": (DeviceSelector, True),
                  "config": (DeviceClassConfig, True)},
    DeviceClassConfig: {"opaque": (OpaqueConfig, False)},
    DeviceRequest: {"selectors": (DeviceSelector, True)},
    DeviceClaim: {"requests": (DeviceRequest, True),
                  "constraints": (DeviceConstraint, True),
                  "config": (ClaimConfig, True)},
    ClaimConfig: {"opaque": (OpaqueConfig, False)},
    ResourceClaimSpec: {"devices": (DeviceClaim, False)},
    ResourceClaim: {"metadata": (ObjectMeta, False),
                    "spec": (ResourceClaimSpec, False),
                    "status": (ResourceClaimStatus, False)},
    ResourceClaimStatus: {"allocation": (AllocationResult, False)},
    AllocationResult: {"results": (DeviceRequestAllocationResult, True),
                       "config": (AllocatedDeviceConfig, True)},
    AllocatedDeviceConfig: {"opaque": (OpaqueConfig, False)},
}
