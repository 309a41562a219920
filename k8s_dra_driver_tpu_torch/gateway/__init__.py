"""Fleet gateway over port engines: SLO-aware admission, prefix-affinity
routing, and health-driven drain over a pool of ``ServingEngine``\\ s.

The port of ``k8s_dra_driver_tpu/gateway/`` (admission, routers,
replica lifecycle, ``FleetGateway``, capacity calibration and the
offered-load probe).  The sharded and multi-process gateways, the wire
codec, the outcome store, the load generator, the burn-rate engine and
the other probes wait for later slices (ROADMAP Queue A item 5).
"""

from .admission import (AdmissionError, AdmissionQueue, GatewayRequest,
                        FINISHED, REJECTED_DUPLICATE, REJECTED_FULL,
                        REJECTED_INVALID, SHED_EXPIRED)
from .calibrate import Capacity, calibrate_capacity
from .frontend import FleetGateway
from .probe import gateway_probe
from .replica import (EngineReplica, ReplicaManager, ROLE_DECODE,
                      ROLE_PREFILL, ROLE_UNIFIED)
from .router import (LeastLoadedRouter, PrefixAffinityRouter,
                     RoundRobinRouter, Router)

__all__ = [
    "AdmissionError", "AdmissionQueue", "Capacity", "EngineReplica",
    "FINISHED", "FleetGateway", "GatewayRequest", "LeastLoadedRouter",
    "PrefixAffinityRouter", "REJECTED_DUPLICATE", "REJECTED_FULL",
    "REJECTED_INVALID", "ROLE_DECODE", "ROLE_PREFILL", "ROLE_UNIFIED",
    "ReplicaManager", "RoundRobinRouter", "Router", "SHED_EXPIRED",
    "calibrate_capacity", "gateway_probe",
]
