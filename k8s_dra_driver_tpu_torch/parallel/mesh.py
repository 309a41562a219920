"""The process mesh of the port: the JAX package's mesh axes over
``torch.distributed`` process groups, one process (and one card) per
mesh position.

The port of ``k8s_dra_driver_tpu/parallel/mesh.py``.  ``MESH_AXES``,
``BATCH_AXES`` and :class:`MeshSpec` are the JAX package's.  Where JAX
lays a ``Mesh`` over devices and shards global arrays with
``shard_map``, the port runs one process per mesh position: rank r sits
at the row-major position of r in ``(dp, ep, sp, tp, pp)``, as
``np.reshape(devices, ...)`` places devices in the JAX ``make_mesh``,
and :func:`make_mesh` builds one process group per axis line from the
initialized default group.  Each process holds its own shard of the
batch and the sequence, and the collectives below move what the
sharded layout needs between processes.

This slice runs dp and sp: tp, ep and pp larger than 1 raise
``NotImplementedError`` (ROADMAP Queue A item 6b).

:class:`PartitionSpec` (alias ``P``) is the port's own layout
annotation: a tuple with one entry per array dimension, each an axis
name, a tuple of axis names or ``None`` (replicated), as JAX's
``jax.sharding.PartitionSpec`` holds them.  The layout tables
(models/layouts.py) and the sharded checkpoint format
(parallel/resharding.py) are written in it; ``resharding.encode_spec``
gives the same JSON list for a spec of either package.

Transport follows the group's backend.  NCCL (one card per rank) moves
CUDA tensors as they are.  Gloo carries host tensors only, so a gloo
group stages each CUDA tensor through host memory on its way
(:meth:`ProcessMesh.host_staged`): the compute stays on the card, the
bytes cross the host.  That is the setup of several ranks sharing one
card, which NCCL refuses, and of the CPU tests.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

MESH_AXES = ("dp", "ep", "sp", "tp", "pp")

# Batch dimension is sharded over every data-like axis.
BATCH_AXES = ("dp", "ep")

#: mesh axes this slice of the port runs at sizes above 1
SUPPORTED_AXES = ("dp", "sp")


def _canonical_entry(entry):
    """One entry as JAX's ``PartitionSpec`` keeps it: a list becomes a
    tuple, a one-axis tuple its axis name, an empty tuple ``None``."""
    if isinstance(entry, (list, tuple)):
        entry = tuple(entry)
        if len(entry) == 0:
            return None
        if len(entry) == 1:
            return entry[0]
    return entry


class PartitionSpec(tuple):
    """Per-dimension placement of an array over the mesh axes: each
    entry an axis name, a tuple of axis names, or ``None``.  Dimensions
    past the last entry are replicated, so ``P()`` replicates the whole
    array."""

    def __new__(cls, *entries):
        return super().__new__(cls, map(_canonical_entry, entries))

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    pp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.ep * self.sp * self.tp * self.pp

    def axis_sizes(self) -> dict[str, int]:
        return {"dp": self.dp, "ep": self.ep, "sp": self.sp,
                "tp": self.tp, "pp": self.pp}

    @classmethod
    def infer(cls, n_devices: int) -> "MeshSpec":
        """A sensible default factorization: tp gets up to 2, sp up to 2,
        the rest goes to dp."""
        tp = 2 if n_devices % 2 == 0 else 1
        rem = n_devices // tp
        sp = 2 if rem % 2 == 0 and rem >= 2 else 1
        rem //= sp
        ep = 2 if rem % 2 == 0 and rem >= 2 else 1
        dp = rem // ep
        spec = cls(dp=dp, ep=ep, sp=sp, tp=tp)
        assert spec.num_devices == n_devices, (spec, n_devices)
        return spec


def require_supported(spec: MeshSpec) -> None:
    """Raise ``NotImplementedError`` when ``spec`` sets an axis the port
    does not run yet (tp, ep or pp above 1)."""
    unsupported = {a: n for a, n in spec.axis_sizes().items()
                   if n > 1 and a not in SUPPORTED_AXES}
    if unsupported:
        raise NotImplementedError(
            f"mesh axes {unsupported} are not ported yet: the port runs dp "
            f"and sp; tp, ep and pp come with the rest of the parallelism "
            f"slice (ROADMAP Queue A item 6b)")


def mesh_coords(rank: int, spec: MeshSpec) -> dict[str, int]:
    """The mesh position of ``rank``: its row-major index in
    ``(dp, ep, sp, tp, pp)``."""
    coords = {}
    for axis in reversed(MESH_AXES):
        size = spec.axis_sizes()[axis]
        coords[axis] = rank % size
        rank //= size
    return {axis: coords[axis] for axis in MESH_AXES}


def mesh_rank(coords: dict[str, int], spec: MeshSpec) -> int:
    """Inverse of :func:`mesh_coords`."""
    rank = 0
    for axis in MESH_AXES:
        rank = rank * spec.axis_sizes()[axis] + coords[axis]
    return rank


class _Pending:
    """Receives of :meth:`ProcessMesh.exchange_start` in flight."""

    def __init__(self, works, bufs, device):
        self._works, self._bufs, self._device = works, bufs, device

    def wait(self) -> list[torch.Tensor]:
        for work in self._works:
            work.wait()
        return [b.to(self._device) for b in self._bufs]


class ProcessMesh:
    """The mesh as this process sees it: the spec, its device, its
    position, and one process group per axis of size > 1 (the ranks of
    its line along that axis, in coordinate order).  Built by
    :func:`make_mesh`.

    The collectives take the axis by name (``None``: the whole world)
    and are identities on an axis of size 1."""

    def __init__(self, spec: MeshSpec, device: torch.device, rank: int,
                 groups: dict, lines: dict):
        self.spec = spec
        self.device = device
        self.rank = rank
        self.coords = mesh_coords(rank, spec)
        self._groups = groups
        self._lines = lines

    @property
    def world_size(self) -> int:
        return self.spec.num_devices

    def size(self, axis: str) -> int:
        return self.spec.axis_sizes()[axis]

    def index(self, axis: str) -> int:
        """This process's coordinate along ``axis``."""
        return self.coords[axis]

    def group(self, axis: str | None):
        """The process group of ``axis`` (None: the default group, the
        world); None for an axis of size 1."""
        if axis is None:
            return dist.group.WORLD
        return self._groups.get(axis)

    def line(self, axis: str) -> list[int]:
        """Global ranks along ``axis`` through this process, by
        coordinate."""
        return self._lines.get(axis, [self.rank])

    def host_staged(self, axis: str | None) -> bool:
        """Whether the group carries host tensors only (gloo) while the
        mesh computes on a card: its collectives then stage each CUDA
        tensor through host memory."""
        return (self.device.type == "cuda"
                and dist.get_backend(self.group(axis)) == "gloo")

    def _wire(self, x: torch.Tensor, axis) -> torch.Tensor:
        # gloo moves host tensors only: a CUDA tensor crosses as a host
        # copy (compute stays on the card)
        return x.cpu() if self.host_staged(axis) else x

    def local_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This process's shard of a global ``[B, T, ...]`` batch: the
        rows of its ``dp`` coordinate, the columns of its ``sp`` one."""
        b, t = x.shape[0], x.shape[1]
        dp, sp = self.size("dp"), self.size("sp")
        if b % dp or t % sp:
            raise ValueError(f"batch [B={b}, T={t}] does not split over "
                             f"dp={dp} x sp={sp}")
        bi, si = self.index("dp"), self.index("sp")
        return x[bi * (b // dp):(bi + 1) * (b // dp),
                 si * (t // sp):(si + 1) * (t // sp)]

    def all_reduce_(self, x: torch.Tensor, axis: str | None = None):
        """Sum ``x`` over ``axis`` (None: the world), in place."""
        if axis is not None and self.size(axis) == 1:
            return x
        wire = self._wire(x, axis)
        dist.all_reduce(wire, group=self.group(axis))
        if wire is not x:
            x.copy_(wire)
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0):
        """Every process's ``x`` along ``axis``, concatenated on ``dim``
        in coordinate order."""
        if self.size(axis) == 1:
            return x
        wire = self._wire(x.contiguous(), axis)
        parts = [torch.empty_like(wire) for _ in range(self.size(axis))]
        dist.all_gather(parts, wire, group=self.group(axis))
        return torch.cat(parts, dim=dim).to(x.device)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` [S, ...]: chunk j goes to coordinate j along ``axis``;
        the result's chunk i came from coordinate i."""
        if self.size(axis) == 1:
            return x
        wire = self._wire(x.contiguous(), axis)
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=self.group(axis))
        return out.to(x.device)

    def exchange_start(self, tensors, axis: str, send_to: int,
                       recv_from: int) -> _Pending:
        """Send ``tensors`` to coordinate ``send_to`` along ``axis`` and
        receive as many of the same shapes from ``recv_from``, in one
        ``batch_isend_irecv``; ``.wait()`` on the result returns the
        received tensors on this mesh's device."""
        if self.size(axis) == 1:
            return _Pending([], list(tensors), self.device)
        line = self.line(axis)
        group = self.group(axis)
        ops, bufs = [], []
        for x in tensors:
            wire = self._wire(x.contiguous(), axis)
            buf = torch.empty_like(wire)
            ops.append(dist.P2POp(dist.isend, wire, line[send_to], group))
            ops.append(dist.P2POp(dist.irecv, buf, line[recv_from], group))
            bufs.append(buf)
        return _Pending(dist.batch_isend_irecv(ops), bufs, self.device)

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.spec}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device})")


def make_mesh(spec: MeshSpec | None = None, device="cuda") -> ProcessMesh:
    """The mesh of ``spec`` over the initialized default process group
    (default: every rank on ``dp``), computing on ``device``.

    Every rank must call it, with the same spec, in the same order as
    its other group-making calls: each axis line becomes a process group
    (``dist.new_group`` is collective over the world).  Raises
    ``ValueError`` when the spec's device count differs from the world
    size and ``NotImplementedError`` for tp, ep or pp > 1."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.rendezvous.initialize first")
    world = dist.get_world_size()
    spec = spec or MeshSpec(dp=world)
    if spec.num_devices != world:
        raise ValueError(f"mesh {spec} wants {spec.num_devices} devices, "
                         f"have {world} processes")
    require_supported(spec)
    dev = resolve_device(device)
    rank = dist.get_rank()
    sizes = spec.axis_sizes()
    groups, lines = {}, {}
    for axis in MESH_AXES:
        if sizes[axis] == 1:
            continue
        others = [a for a in MESH_AXES if a != axis]
        # every line along the axis, in one order on every rank
        for fixed in itertools.product(*(range(sizes[a]) for a in others)):
            coords = dict(zip(others, fixed))
            ranks = [mesh_rank({**coords, axis: i}, spec)
                     for i in range(sizes[axis])]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis], lines[axis] = group, ranks
    return ProcessMesh(spec, dev, rank, groups, lines)


__all__ = ["BATCH_AXES", "MESH_AXES", "MeshSpec", "P", "PartitionSpec",
           "ProcessMesh", "SUPPORTED_AXES", "make_mesh", "mesh_coords",
           "mesh_rank", "require_supported"]
