"""Fleet gateway over port engines: SLO-aware admission, prefix-affinity
routing, and health-driven drain over a pool of ``ServingEngine``\\ s.

The port of ``k8s_dra_driver_tpu/gateway/``: admission, routers,
replica lifecycle, ``FleetGateway``, capacity calibration and the
offered-load probe; the in-process sharded tier (sharded.py), the
open-loop load generator (loadgen.py) and the control-plane ceiling
probe over no-op engines (ctlprobe.py); and the multi-process gateway:
pump processes and their conductor (procpump.py, imported on its own:
it is also the worker's ``-m`` module), the wire codec (wire.py), the
durable outcome journal (outcome_store.py) and the scaling probe
(procprobe.py); the per-tenant SLO burn-rate engine (burnrate.py) and
the observatory probe (obsprobe.py, imported on its own).
"""

from .admission import (AdmissionError, AdmissionQueue, GatewayRequest,
                        FINISHED, REJECTED_DUPLICATE, REJECTED_FULL,
                        REJECTED_INVALID, SHED_EXPIRED)
from .burnrate import SloBurnEngine
from .calibrate import Capacity, calibrate_capacity
from .ctlprobe import NullEngine, control_plane_probe
from .frontend import FleetGateway
from .probe import gateway_probe
from .replica import (DraChipLease, EngineReplica, ReplicaManager,
                      ROLE_DECODE, ROLE_PREFILL, ROLE_UNIFIED,
                      card_health_source, resolve_container_path)
from .router import (LeastLoadedRouter, PrefixAffinityRouter,
                     RoundRobinRouter, Router)
from .sharded import ShardedGateway

__all__ = [
    "AdmissionError", "AdmissionQueue", "Capacity", "DraChipLease",
    "EngineReplica",
    "FINISHED", "FleetGateway", "GatewayRequest", "LeastLoadedRouter",
    "NullEngine", "PrefixAffinityRouter", "REJECTED_DUPLICATE", "REJECTED_FULL",
    "REJECTED_INVALID", "ROLE_DECODE", "ROLE_PREFILL", "ROLE_UNIFIED",
    "ReplicaManager", "RoundRobinRouter", "Router", "SHED_EXPIRED",
    "ShardedGateway", "SloBurnEngine", "calibrate_capacity",
    "card_health_source", "control_plane_probe", "gateway_probe",
    "resolve_container_path",
]
