"""The process mesh and the gang rendezvous of the port: the dp x sp
mesh over ``torch.distributed`` process groups (``mesh``) and the
workload side of the driver's rendezvous contract (``rendezvous``)."""

from .mesh import BATCH_AXES, MESH_AXES, MeshSpec, ProcessMesh, make_mesh
from .rendezvous import (ContractError, RendezvousSpec, gang_psum,
                         initialize, spec_from_env)

__all__ = ["BATCH_AXES", "MESH_AXES", "ContractError", "MeshSpec",
           "ProcessMesh", "RendezvousSpec", "gang_psum", "initialize",
           "make_mesh", "spec_from_env"]
