"""Slice-gang controller: cluster-wide multi-host TPU resources.

The port of ``k8s_dra_driver_tpu/controller/slices.py``, device-agnostic
and unchanged: it watches Nodes, not devices.  An NVIDIA host carries no
slice label, so the controller publishes nothing for it.

The analog of the reference's IMEX manager (reference
cmd/nvidia-dra-controller/imex.go:67-422), translated to TPU pod slices:

- Nodes carry a ``tpu.google.com/slice=<sliceId>.<topology>`` label
  (the imex-domain label analog, imex.go:217-305); GKE's TPU stack or
  the kubelet plugin itself (Driver.start self-labeling) sets it from
  discovery.
- The controller ref-counts labeled nodes per slice and, on 0↔1
  transitions, adds/removes the slice (streamImexDomains analog,
  imex.go:243-287).
- Each active slice gets a block of rendezvous-channel ids carved out
  of a fixed space (imexDomainOffsets analog, imex.go:329-368: 2048
  channels, 128 per slice) and a ResourceSlice pool scoped to the
  slice's nodes via node selector (generateImexChannelPool analog,
  imex.go:381-422) containing:
    * ``channel-<i>`` rendezvous devices — claim one per workload gang
      and share it across the gang's pods (imex-test1 pattern);
    * one ``podslice`` gang device representing the whole multi-host
      slice (topology/numWorkers attributes) for all-or-nothing
      multi-host claims.
- Transient publish errors requeue after a delay (transientError retry
  analog, imex.go:49-53,142-162); ``stop()`` deletes every owned
  ResourceSlice (cleanupResourceSlices analog, imex.go:308-326).
"""

from __future__ import annotations

import threading

from ..api import resource
from ..cluster import (ClusterClient, EVENT_DELETED, Node)
from ..plugin.publisher import PoolSpec, ResourceSlicePublisher
from ..utils.metrics import DriverMetrics

from .. import SLICE_LABEL

DRIVER_NAME = "tpu.google.com"

TOTAL_CHANNELS = 2048
CHANNELS_PER_SLICE = 128
RETRY_DELAY_S = 60.0


def slice_label_value(slice_id: str, topology: str) -> str:
    return f"{slice_id}.{topology}"


def parse_slice_label(value: str) -> tuple[str, str]:
    """Split "<sliceId>.<topology>" (sliceId may itself contain dots)."""
    slice_id, _, topology = value.rpartition(".")
    if not slice_id or "x" not in topology:
        raise ValueError(f"bad {SLICE_LABEL} value {value!r}")
    return slice_id, topology


class ChannelOffsets:
    """Carves the channel space into per-slice blocks
    (imexDomainOffsets analog, imex.go:329-368)."""

    def __init__(self, total: int = TOTAL_CHANNELS,
                 per_slice: int = CHANNELS_PER_SLICE):
        self.per_slice = per_slice
        self._free = list(range(0, total, per_slice))
        self._assigned: dict[str, int] = {}

    def add(self, key: str) -> int:
        if key in self._assigned:
            return self._assigned[key]
        if not self._free:
            raise RuntimeError("rendezvous channel space exhausted")
        off = self._free.pop(0)
        self._assigned[key] = off
        return off

    def remove(self, key: str) -> None:
        off = self._assigned.pop(key, None)
        if off is not None:
            self._free.append(off)
            self._free.sort()

    def get(self, key: str) -> int | None:
        return self._assigned.get(key)


class SliceGangController:
    def __init__(self, client: ClusterClient, driver: str = DRIVER_NAME,
                 owner: resource.OwnerReference | None = None,
                 metrics: DriverMetrics | None = None,
                 channels_per_slice: int = CHANNELS_PER_SLICE,
                 retry_delay_s: float = RETRY_DELAY_S):
        self.client = client
        self.driver = driver
        self.metrics = metrics
        self.publisher = ResourceSlicePublisher(
            client, driver, owner_id="controller", owner=owner,
            metrics=metrics)
        self.offsets = ChannelOffsets(per_slice=channels_per_slice)
        self.retry_delay_s = retry_delay_s
        self._lock = threading.Lock()
        # slice label value -> set of node names carrying it
        self._members: dict[str, set[str]] = {}
        self._unsubscribe = None
        self._retry_timer: threading.Timer | None = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._unsubscribe = self.client.watch("Node", self._on_node_event)

    def stop(self) -> None:
        if self._unsubscribe:
            self._unsubscribe()
            self._unsubscribe = None
        if self._retry_timer:
            self._retry_timer.cancel()
        self.publisher.cleanup()

    # -- node watch -------------------------------------------------------

    def _on_node_event(self, event: str, node: Node) -> None:
        name = node.metadata.name
        value = node.metadata.labels.get(SLICE_LABEL, "")
        if event == EVENT_DELETED:
            value = ""
        changed = False
        with self._lock:
            for key, members in list(self._members.items()):
                if key != value and name in members:
                    members.discard(name)
                    changed = True
                    if not members:          # 1 → 0: slice disappears
                        del self._members[key]
                        self.offsets.remove(key)
            if value:
                members = self._members.setdefault(value, set())
                if name not in members:
                    members.add(name)
                    changed = True
                    self.offsets.add(value)   # 0 → 1: slice appears
        if changed:
            self.reconcile()

    # -- reconcile --------------------------------------------------------

    def reconcile(self) -> None:
        try:
            with self._lock:
                pools = [self._pool_for(value)
                         for value in sorted(self._members)]
            self.publisher.publish(pools)
        except Exception:
            # transient-error requeue (imex.go:142-162 analog)
            if self._retry_timer:
                self._retry_timer.cancel()
            self._retry_timer = threading.Timer(self.retry_delay_s,
                                                self.reconcile)
            self._retry_timer.daemon = True
            self._retry_timer.start()

    def _pool_for(self, value: str) -> PoolSpec:
        slice_id, topology = parse_slice_label(value)
        offset = self.offsets.get(value)
        num_workers = len(self._members[value])
        devices: list[resource.Device] = [resource.Device(
            name="podslice",
            attributes={
                "type": "podslice", "sliceId": slice_id,
                "sliceTopology": topology, "numWorkers": num_workers,
            },
            capacity={"slot.podslice": 1},
        )]
        for i in range(self.offsets.per_slice):
            channel = offset + i
            devices.append(resource.Device(
                name=f"channel-{channel}",
                attributes={"type": "rendezvous", "channelId": channel,
                            "sliceId": slice_id},
            ))
        return PoolSpec(
            name=f"slice-{value.replace('.', '-')}",
            devices=devices,
            node_selector={SLICE_LABEL: value},
        )

    # introspection for tests
    def active_slices(self) -> dict[str, set[str]]:
        with self._lock:
            return {k: set(v) for k, v in self._members.items()}
