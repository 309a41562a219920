"""Fleet reconciler: demand-driven autoscaling, gang regrow, and
training/serving chip arbitration over the port's gateways.

The port of ``k8s_dra_driver_tpu/fleet/``.  One control loop above the
subsystems: demand from the gateway's metrics, supply from the chip
ledger's health-and-ownership view, hysteresis policy in between, and
actuation exclusively through existing machinery — replica
scale-up/drain/retire and the gang supervisor's ``request_width`` /
``readmit`` / ``park`` / ``update_fence`` (parallel/supervisor.py's
``GangSupervisor``; duck-typed, so any object with those verbs
serves).  The
multi-tenant tier (tenancy.py + binpack.py) generalizes the loop from
1x1 to N gangs + N pools: per-tenant quotas/priority classes/floors, a
fair-share arbiter with a strict-priority preemption cascade, adapter
quotas, and topology bin-packing with link-domain overlap tokens.
"""

from .binpack import Placement, TopologyBinPacker
from .policy import (Action, DemandSignals, FleetPolicy, PolicyConfig,
                     Streaks, PREEMPT, REGROW, SCALE_DOWN, SCALE_UP)
from .reconciler import FleetReconciler, read_demand
from .supply import (ChipLedger, SupplyView, owner_tenant,
                     serving_tag, training_tag)
from .tenancy import (FairShareArbiter, MtAction, MtConfig,
                      MultiTenantReconciler, ServingTenant,
                      TenantRegistry, TenantSpec, TenantState,
                      TrainingTenant, entitlements)

__all__ = [
    "Action", "ChipLedger", "DemandSignals", "FairShareArbiter",
    "FleetPolicy", "FleetReconciler", "MtAction", "MtConfig",
    "MultiTenantReconciler", "Placement", "PolicyConfig",
    "ServingTenant", "Streaks", "SupplyView", "TenantRegistry",
    "TenantSpec", "TenantState", "TopologyBinPacker",
    "TrainingTenant", "entitlements", "owner_tenant", "read_demand",
    "serving_tag", "training_tag",
    "PREEMPT", "REGROW", "SCALE_DOWN", "SCALE_UP",
    "fleet_probe", "fragmentation_probe", "multitenant_probe",
]


def __getattr__(name):
    # the probes pull in the models layer: loaded on demand so
    # control-plane consumers stay light
    if name in ("fleet_probe", "fragmentation_probe",
                "multitenant_probe"):
        from . import probe
        return getattr(probe, name)
    raise AttributeError(name)
