"""Prepared-device records: what a node remembers about a prepared claim.

The port's copy of ``k8s_dra_driver_tpu/devicemodel/prepared.py``.

The analog of PreparedDevices / PreparedDeviceGroup (reference
cmd/nvidia-dra-plugin/prepared.go:25-205).  These records are what the
checkpoint persists, so they are plain JSON-serializable data.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class PreparedDevice:
    """One device handed to a claim, with its CDI injection ids."""

    request: str                 # claim request name this satisfies
    kind: str                    # chip | core | slice | rendezvous
    device_name: str             # allocatable-device name, e.g. "chip-0"
    pool: str
    uuids: list[str] = dataclasses.field(default_factory=list)
    chip_indices: list[int] = dataclasses.field(default_factory=list)
    cdi_device_ids: list[str] = dataclasses.field(default_factory=list)
    core_index: int = -1         # for kind == core (default keeps old
                                 # checkpoints loadable)

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "PreparedDevice":
        dev = cls(**d)
        if dev.kind == "core" and dev.core_index < 0:
            # Checkpoint written before core_index existed: recover it
            # from the device name ("chip-<i>-core-<j>") so restarted
            # claims keep their TPU_VISIBLE_CORES injection.
            _, _, tail = dev.device_name.rpartition("-core-")
            if tail.isdigit():
                dev.core_index = int(tail)
        return dev


@dataclasses.dataclass
class PreparedClaim:
    """Everything prepared for one ResourceClaim on this node."""

    claim_uid: str
    claim_namespace: str = ""
    claim_name: str = ""
    devices: list[PreparedDevice] = dataclasses.field(default_factory=list)
    # Names of coordinator daemons started for this claim (teardown keys).
    coordinator_ids: list[str] = dataclasses.field(default_factory=list)
    # Chip indices whose scheduling policy this claim changed (reset keys).
    timesliced_chips: list[int] = dataclasses.field(default_factory=list)

    def all_uuids(self) -> list[str]:
        """Flattened UUID set across groups (UUID set-algebra analog,
        reference prepared.go UUIDProvider)."""
        out: list[str] = []
        for d in self.devices:
            out.extend(d.uuids)
        return out

    def all_cdi_ids(self) -> list[str]:
        out: list[str] = []
        for d in self.devices:
            out.extend(d.cdi_device_ids)
        return out

    def to_json(self) -> dict[str, Any]:
        return {
            "claimUID": self.claim_uid,
            "claimNamespace": self.claim_namespace,
            "claimName": self.claim_name,
            "devices": [d.to_json() for d in self.devices],
            "coordinatorIDs": list(self.coordinator_ids),
            "timeslicedChips": list(self.timesliced_chips),
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "PreparedClaim":
        return cls(
            claim_uid=d["claimUID"],
            claim_namespace=d.get("claimNamespace", ""),
            claim_name=d.get("claimName", ""),
            devices=[PreparedDevice.from_json(x) for x in d.get("devices", [])],
            coordinator_ids=list(d.get("coordinatorIDs", [])),
            timesliced_chips=list(d.get("timeslicedChips", [])),
        )
