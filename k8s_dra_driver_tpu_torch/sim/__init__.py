"""Discrete-event fleet simulator, the port's copy of the JAX package's
``sim/``.

It scales the port's policy layer (the topology bin-packer, the
fair-share arbiter, the multi-tenant reconciler, and the crucible's
fault schedules and invariant checkers) onto a simulated supply and
demand plane: 1000 replicas, 64 link domains, 10k tenants, replayed
diurnal and heavy-tail traces, all seeded-deterministic over an
O(events) event heap (clock.py).  It runs on the host: no tensor, no
device.

The policy objects run UNMODIFIED: workload.py duck-types the
gateway/manager/supervisor surfaces tenancy.py actuates, a plain
ChipLedger carries supply, and cluster/invariants.check_cycle sweeps the
simulated fleet every cycle exactly as it sweeps a live one.

Only the clock is imported eagerly: gateway/loadgen.py re-exports
:class:`VirtualClock` from here, and fleet.py replays loadgen traces; a
lazy ``__getattr__`` (PEP 562) breaks that cycle without making either
side import inside functions.
"""

from .clock import EventHeap, VirtualClock

_LAZY = {
    "FleetSim": "fleet", "SimConfig": "fleet", "build_fleet": "fleet",
    "run_sim_soak": "rig", "sim_soak_for": "rig",
    "SimGateway": "workload", "SimReplica": "workload",
    "SimReplicaManager": "workload", "SimSupervisor": "workload",
}

__all__ = ["EventHeap", "FleetSim", "SimConfig", "SimGateway",
           "SimReplica", "SimReplicaManager", "SimSupervisor",
           "VirtualClock", "build_fleet", "run_sim_soak",
           "sim_soak_for"]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute "
                         f"{name!r}")
