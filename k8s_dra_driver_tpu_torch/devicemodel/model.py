"""Allocatable-device model: the scheduler-visible surface.

The port's copy of ``k8s_dra_driver_tpu/devicemodel/model.py``.  An
H100 publishes the same kinds: a chip, its one core, and, on a host of
several cards, the slices ``standard_slice_shapes`` gives over their
``(k, 0, 0)`` coordinates; it is told apart by its ``generation`` and
``productName`` attributes.

The analog of the reference's typed device records + GetDevice
conversions (reference cmd/nvidia-dra-plugin/{allocatable.go,
deviceinfo.go:98-217}).  This layer is the driver's entire allocation
policy: the upstream structured-parameters model means there is no
imperative scheduler — what we publish *is* the policy (SURVEY §1).

Device kinds published per node:

- ``chip``  — one whole TPU chip (gpu analog).
- ``core``  — one TensorCore partition of a chip (MIG-profile analog).
- ``slice`` — an ICI-contiguous in-host box of chips (2x1, 2x2, ...),
  pre-enumerated at aligned placements (NVLink-clique / MIG-placement
  analog).

Overlap is made scheduler-enforceable through *shared capacity tokens*:
capacity names beginning with ``slot.`` are drawn from a single per-pool
counter (supply 1 each).  A chip consumes its chip slot and all its core
slots; a core consumes one core slot; a slice consumes every member
chip's chip+core slots.  Any two devices that overlap physically collide
on at least one token, so the allocator can never hand out both — the
MIG ``memorySlice<i>`` capacity technique (reference
deviceinfo.go:195-198) generalized to 2-level partitions and multi-chip
slices.
"""

from __future__ import annotations

import dataclasses

from ..api import resource
from ..discovery import (ChipInfo, HostTopology, ICICoord, MeshShape,
                         standard_slice_shapes)

KIND_CHIP = "chip"
KIND_CORE = "core"
KIND_SLICE = "slice"
KIND_RENDEZVOUS = "rendezvous"
# The whole multi-host pod slice as one gang device (controller-published;
# the node plugin synthesizes it at prepare time).
KIND_PODSLICE = "podslice"

ALL_DEVICE_KINDS = (KIND_CHIP, KIND_CORE, KIND_SLICE, KIND_RENDEZVOUS,
                    KIND_PODSLICE)


def chip_slot(index: int) -> str:
    return f"slot.chip.{index}"


def core_slot(chip_index: int, core_index: int) -> str:
    return f"slot.core.{chip_index}.{core_index}"


def is_shared_token(capacity_name: str) -> bool:
    return capacity_name.startswith("slot.")


@dataclasses.dataclass(frozen=True)
class AllocatableDevice:
    """Tagged union over the device kinds (allocatable.go analog)."""

    kind: str
    chips: tuple[ChipInfo, ...]            # member chips (1 for chip/core)
    core_index: int = -1                   # for KIND_CORE
    shape: MeshShape | None = None         # for KIND_SLICE
    origin: ICICoord | None = None         # for KIND_SLICE
    channel_id: int = -1                   # for KIND_RENDEZVOUS
    slice_id: str = ""                     # multi-host slice identity

    @property
    def name(self) -> str:
        if self.kind == KIND_CHIP:
            return f"chip-{self.chips[0].index}"
        if self.kind == KIND_CORE:
            return f"chip-{self.chips[0].index}-core-{self.core_index}"
        if self.kind == KIND_SLICE:
            o = self.origin
            return f"slice-{self.shape}-at-{o.x}-{o.y}-{o.z}"
        if self.kind == KIND_RENDEZVOUS:
            return f"channel-{self.channel_id}"
        if self.kind == KIND_PODSLICE:
            return "podslice"
        raise ValueError(self.kind)

    @property
    def uuids(self) -> list[str]:
        if self.kind == KIND_CORE:
            return [f"{self.chips[0].uuid}/core{self.core_index}"]
        return [c.uuid for c in self.chips]

    @property
    def hbm_bytes(self) -> int:
        if self.kind == KIND_CORE:
            c = self.chips[0]
            return c.hbm_bytes // c.cores
        return sum(c.hbm_bytes for c in self.chips)

    def to_device(self) -> resource.Device:
        """Render the scheduler-visible Device (GetDevice analog,
        reference deviceinfo.go:98-217)."""
        attrs: dict[str, resource.AttrValue] = {"type": self.kind}
        cap: dict[str, int] = {}
        if self.kind == KIND_RENDEZVOUS:
            attrs["channelId"] = self.channel_id
            attrs["sliceId"] = self.slice_id
            return resource.Device(self.name, attrs, cap)

        gen = self.chips[0].generation
        attrs["generation"] = gen.name
        attrs["productName"] = gen.product_name
        cap["hbm"] = self.hbm_bytes

        if self.kind == KIND_CHIP:
            c = self.chips[0]
            attrs.update({
                "uuid": c.uuid, "index": c.index, "coreCount": c.cores,
                "ici.x": c.coord.x, "ici.y": c.coord.y, "ici.z": c.coord.z,
                "parentUUID": c.uuid,
            })
            cap[chip_slot(c.index)] = 1
            for j in range(c.cores):
                cap[core_slot(c.index, j)] = 1
        elif self.kind == KIND_CORE:
            c = self.chips[0]
            attrs.update({
                "uuid": self.uuids[0], "index": c.index,
                "coreIndex": self.core_index, "coreCount": 1,
                "ici.x": c.coord.x, "ici.y": c.coord.y, "ici.z": c.coord.z,
                "parentUUID": c.uuid,
            })
            cap[core_slot(c.index, self.core_index)] = 1
        elif self.kind == KIND_SLICE:
            attrs.update({
                "sliceShape": str(self.shape),
                "numChips": len(self.chips),
                "ici.x": self.origin.x, "ici.y": self.origin.y,
                "ici.z": self.origin.z,
            })
            for c in self.chips:
                cap[chip_slot(c.index)] = 1
                for j in range(c.cores):
                    cap[core_slot(c.index, j)] = 1
        if self.slice_id:
            attrs["sliceId"] = self.slice_id
        return resource.Device(self.name, attrs, cap)


def enumerate_host_devices(
        topo: HostTopology,
        kinds: tuple[str, ...] = (KIND_CHIP, KIND_CORE, KIND_SLICE),
) -> dict[str, AllocatableDevice]:
    """All allocatable devices on one host, keyed by device name.

    The enumerateAllPossibleDevices analog (reference nvlib.go:111-136),
    gated by enabled device kinds the way the reference gates on
    --device-classes (nvlib.go:113-133).
    """
    out: dict[str, AllocatableDevice] = {}
    slice_id = topo.slice.slice_id if topo.slice else ""
    if KIND_CHIP in kinds:
        for c in topo.chips:
            d = AllocatableDevice(KIND_CHIP, (c,), slice_id=slice_id)
            out[d.name] = d
    if KIND_CORE in kinds:
        for c in topo.chips:
            for j in range(c.cores):
                d = AllocatableDevice(KIND_CORE, (c,), core_index=j,
                                      slice_id=slice_id)
                out[d.name] = d
    if KIND_SLICE in kinds and topo.chips:
        bounds = topo.host_bounds
        origin0 = min(c.coord for c in topo.chips)
        by_coord = {c.coord.as_tuple(): c for c in topo.chips}
        for shape in standard_slice_shapes(topo.generation, bounds):
            for rel in shape.placements(bounds):
                abs_origin = ICICoord(origin0.x + rel.x, origin0.y + rel.y,
                                      origin0.z + rel.z)
                members = []
                for dx, dy, dz in shape.offsets():
                    key = (abs_origin.x + dx, abs_origin.y + dy,
                           abs_origin.z + dz)
                    if key not in by_coord:
                        members = None
                        break
                    members.append(by_coord[key])
                if not members:
                    continue
                d = AllocatableDevice(
                    KIND_SLICE, tuple(members), shape=shape,
                    origin=abs_origin, slice_id=slice_id)
                out[d.name] = d
    return out
