"""Cluster access and control-plane plumbing shared by the port's
layers: the client interface and fake API server (client.py), the
in-process event bus and its cross-process tap (bus.py), fault
injection (faults.py), the fleet invariants (invariants.py), the
flight recorder (flightrec.py) and the compound-fault crucible
(crucible.py, chaosprobe.py), the driver's object kinds (objects.py:
Node, Pod, Deployment), a demo spec's claims as the claim controller
makes them (specs.py) and the REST client of a real API server (rest.py,
imported on demand)."""

from .client import (ApiServerError, ApiUnavailableError, ClusterClient,
                     ConflictError, EVENT_ADDED, EVENT_DELETED,
                     EVENT_MODIFIED, FakeCluster, NotFoundError, match_labels)
from .faults import (FaultPlan, FaultRule, FaultyClusterClient,
                     ScriptedChipHealth)
from .invariants import check_cycle
from .objects import Deployment, Node, Pod

__all__ = [
    "ApiServerError", "ApiUnavailableError", "ClusterClient",
    "ConflictError", "Deployment", "EVENT_ADDED", "EVENT_DELETED",
    "EVENT_MODIFIED", "FakeCluster", "FaultEvent", "FaultPlan",
    "FaultRule", "FaultyClusterClient", "Node", "NotFoundError", "Pod",
    "Schedule", "check_cycle", "default_schedule", "match_labels",
    "run_soak", "ScriptedChipHealth",
]


def __getattr__(name):
    # the crucible pulls in the whole workload stack: loaded on demand
    # so `import ...cluster` stays light
    if name in ("FaultEvent", "Schedule", "default_schedule",
                "run_soak"):
        from . import crucible
        return getattr(crucible, name)
    raise AttributeError(name)
