"""The process mesh, the gang rendezvous and training recovery of the
port: the dp x ep x sp x tp x pp mesh over ``torch.distributed``
process groups and its differentiable collectives (``mesh``), GPipe
pipelining over its pp axis (``pipeline``), the workload side of the
driver's rendezvous contract (``rendezvous``), the sharded checkpoint
format (``resharding``), the elastic gang supervisor (``supervisor``)
and its recovery and resharding probes (``probe``)."""

from .mesh import (BATCH_AXES, MESH_AXES, MeshSpec, P, PartitionSpec,
                   ProcessMesh, log2_int, make_mesh, visible_chip_count)
from .pipeline import pipeline_apply, split_layers, stack_stages
from .rendezvous import (ContractError, RendezvousSpec, gang_psum,
                         initialize, spec_from_env)

__all__ = ["BATCH_AXES", "MESH_AXES", "ContractError", "MeshSpec", "P",
           "PartitionSpec", "ProcessMesh", "RendezvousSpec", "gang_psum",
           "initialize", "log2_int", "make_mesh", "pipeline_apply",
           "spec_from_env", "split_layers", "stack_stages",
           "visible_chip_count",
           "ElasticTrainJob", "GangSupervisor", "SupervisorError",
           "SupervisorReport", "recovery_probe", "resharding_probe",
           "ShardCorruption", "ShardedCheckpointer",
           "match_partition_rules"]

_LAZY = {"ElasticTrainJob": "supervisor", "GangSupervisor": "supervisor",
         "SupervisorError": "supervisor", "SupervisorReport": "supervisor",
         "recovery_probe": "probe", "resharding_probe": "probe",
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
