"""The process mesh, the gang rendezvous and training recovery of the
port: the dp x sp mesh over ``torch.distributed`` process groups
(``mesh``), the workload side of the driver's rendezvous contract
(``rendezvous``), the sharded checkpoint format (``resharding``), the
elastic gang supervisor (``supervisor``) and its recovery probe
(``probe``)."""

from .mesh import (BATCH_AXES, MESH_AXES, MeshSpec, P, PartitionSpec,
                   ProcessMesh, make_mesh)
from .rendezvous import (ContractError, RendezvousSpec, gang_psum,
                         initialize, spec_from_env)

__all__ = ["BATCH_AXES", "MESH_AXES", "ContractError", "MeshSpec", "P",
           "PartitionSpec", "ProcessMesh", "RendezvousSpec", "gang_psum",
           "initialize", "make_mesh", "spec_from_env",
           "ElasticTrainJob", "GangSupervisor", "SupervisorError",
           "SupervisorReport", "recovery_probe", "ShardCorruption",
           "ShardedCheckpointer", "match_partition_rules"]

_LAZY = {"ElasticTrainJob": "supervisor", "GangSupervisor": "supervisor",
         "SupervisorError": "supervisor", "SupervisorReport": "supervisor",
         "recovery_probe": "probe",
         "ShardCorruption": "resharding",
         "ShardedCheckpointer": "resharding",
         "match_partition_rules": "resharding"}


def __getattr__(name):
    # supervisor/probe pull in the models layer: loaded on demand so
    # mesh-only consumers stay light, as in the reference package
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(name)
