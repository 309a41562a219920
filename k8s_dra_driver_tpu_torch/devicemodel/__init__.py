"""Device model: allocatable + prepared device records (the port's copy
of ``k8s_dra_driver_tpu/devicemodel``)."""

from .model import (ALL_DEVICE_KINDS, AllocatableDevice, KIND_CHIP, KIND_CORE,
                    KIND_PODSLICE, KIND_RENDEZVOUS, KIND_SLICE, chip_slot,
                    core_slot, enumerate_host_devices, is_shared_token)
from .prepared import PreparedClaim, PreparedDevice

__all__ = [
    "ALL_DEVICE_KINDS", "AllocatableDevice", "KIND_CHIP", "KIND_CORE",
    "KIND_PODSLICE", "KIND_RENDEZVOUS", "KIND_SLICE", "chip_slot", "core_slot",
    "enumerate_host_devices", "is_shared_token", "PreparedClaim",
    "PreparedDevice",
]
