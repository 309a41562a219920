"""Wire protocol: generated protobuf messages + hand-written gRPC glue.

The port's copy of ``k8s_dra_driver_tpu/proto``.  ``dra_pb2`` and
``registration_pb2`` carry the reference's serialized descriptors byte
for byte: both packages register ``dra.proto`` and
``registration.proto`` in protobuf's one process-wide pool, which takes
a file a second time only when its bytes are equal, and the bytes are
the kubelet's wire contract.
"""

from . import dra_pb2, registration_pb2
from .services import (DRAPluginServicer, DRAPluginStub, RegistrationServicer,
                       RegistrationStub, add_dra_servicer,
                       add_registration_servicer)

__all__ = [
    "dra_pb2", "registration_pb2", "DRAPluginServicer", "DRAPluginStub",
    "RegistrationServicer", "RegistrationStub", "add_dra_servicer",
    "add_registration_servicer",
]
