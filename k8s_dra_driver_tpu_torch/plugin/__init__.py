"""Kubelet-plugin side of the driver: DeviceState, CDI, checkpoint,
sharing managers, gRPC NodeServer (the port's copy of
``k8s_dra_driver_tpu/plugin``, with the NVIDIA container contract in
cdi.py).  Imports no ``torch``."""

from .cdi import (CDI_CLAIM_KIND, CDI_DEVICE_KIND, CDIHandler, ContainerEdits,
                  claim_topology_edits)
from .checkpoint import CheckpointManager, ChecksumError
from .device_state import (DRIVER_NAME, DeviceState, DeviceStateConfig,
                           PrepareError)
from .sharing import (CoordinatorDaemon, CoordinatorManager, SharingError,
                      TimeSlicingManager)
from .publisher import PoolSpec, ResourceSlicePublisher
from .driver import Driver, PLUGIN_SOCKET_NAME, REGISTRAR_SOCKET_NAME

__all__ = [
    "CDI_CLAIM_KIND", "CDI_DEVICE_KIND", "CDIHandler", "CheckpointManager",
    "ChecksumError", "ContainerEdits", "CoordinatorDaemon",
    "CoordinatorManager", "DRIVER_NAME", "DeviceState", "DeviceStateConfig",
    "PrepareError", "SharingError", "TimeSlicingManager",
    "claim_topology_edits", "PoolSpec", "ResourceSlicePublisher", "Driver",
    "PLUGIN_SOCKET_NAME", "REGISTRAR_SOCKET_NAME",
]
