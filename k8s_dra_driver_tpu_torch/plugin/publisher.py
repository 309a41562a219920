"""ResourceSlice publication: desired pools → ResourceSlice objects.

The port's copy of ``k8s_dra_driver_tpu/plugin/publisher.py``.  The
analog of the vendored resourceslice controller (reference
vendor/k8s.io/dynamic-resource-allocation/resourceslice/
resourceslicecontroller.go:123, driven from driver.go:79 and
imex.go:129): given the desired set of pools, reconcile the cluster's
ResourceSlice objects — create missing, update changed (bumping pool
generation), delete orphaned.  Used by both the kubelet plugin (per-node
pools) and the controller (slice-gang pools with node selectors).
"""

from __future__ import annotations

import dataclasses

from ..api import resource
from ..cluster import ClusterClient, NotFoundError
from ..utils.metrics import DriverMetrics

DRIVER_LABEL = "tpu.google.com/driver"
# Which publisher instance owns a slice ("node-<name>" or "controller"):
# scopes reconcile/cleanup so publishers never delete each other's slices
# (the role owner references play in the reference, draplugin.go:384-389 /
# imex.go:87-92).
OWNER_LABEL = "tpu.google.com/owned-by"


@dataclasses.dataclass
class PoolSpec:
    """Desired contents of one resource pool."""

    name: str
    devices: list[resource.Device]
    node_name: str = ""
    node_selector: dict[str, str] | None = None
    all_nodes: bool = False


def _slice_name(driver: str, pool: str) -> str:
    return f"{driver.replace('.', '-')}-{pool}".lower()


def _devices_equal(a: list[resource.Device], b: list[resource.Device]) -> bool:
    return [dataclasses.asdict(d) for d in a] == \
           [dataclasses.asdict(d) for d in b]


class ResourceSlicePublisher:
    def __init__(self, client: ClusterClient, driver: str,
                 owner_id: str = "default",
                 owner: resource.OwnerReference | None = None,
                 metrics: DriverMetrics | None = None):
        self.client = client
        self.driver = driver
        self.owner_id = owner_id
        self.owner = owner
        self.metrics = metrics

    def _selector(self) -> dict[str, str]:
        return {DRIVER_LABEL: self.driver, OWNER_LABEL: self.owner_id}

    def publish(self, pools: list[PoolSpec]) -> None:
        """Reconcile cluster ResourceSlices to match ``pools``."""
        desired = {_slice_name(self.driver, p.name): p for p in pools}
        existing = {
            s.metadata.name: s
            for s in self.client.list("ResourceSlice",
                                      label_selector=self._selector())}

        for name, pool in desired.items():
            old = existing.get(name)
            if old is None:
                self.client.create(self._build(name, pool, generation=1))
                self._count("create")
            elif not _devices_equal(old.devices, pool.devices) or \
                    old.node_selector != pool.node_selector:
                new = self._build(name, pool,
                                  generation=old.pool.generation + 1)
                new.metadata = old.metadata
                self.client.update(new)
                self._count("update")

        for name, old in existing.items():
            if name not in desired:
                try:
                    self.client.delete("ResourceSlice",
                                       old.metadata.namespace, name)
                    self._count("delete")
                except NotFoundError:
                    pass
        if self.metrics:
            self.metrics.published_devices.set(
                sum(len(p.devices) for p in pools))

    def cleanup(self) -> None:
        """Delete every slice owned by this driver (controller-stop
        cleanup analog, reference imex.go:308-326)."""
        for s in self.client.list("ResourceSlice",
                                  label_selector=self._selector()):
            try:
                self.client.delete("ResourceSlice", s.metadata.namespace,
                                   s.metadata.name)
                self._count("delete")
            except NotFoundError:
                pass

    def _build(self, name: str, pool: PoolSpec,
               generation: int) -> resource.ResourceSlice:
        meta = resource.ObjectMeta(
            name=name, labels={DRIVER_LABEL: self.driver,
                               OWNER_LABEL: self.owner_id})
        if self.owner is not None:
            meta.owner_references.append(self.owner)
        return resource.ResourceSlice(
            metadata=meta,
            driver=self.driver,
            pool=resource.ResourcePool(name=pool.name, generation=generation),
            node_name=pool.node_name,
            node_selector=pool.node_selector,
            all_nodes=pool.all_nodes,
            devices=list(pool.devices),
        )

    def _count(self, op: str) -> None:
        if self.metrics:
            self.metrics.slice_reconciles.labels(op=op).inc()
