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

Every axis runs at any size: dp and ep shard the batch rows (row-major
over ``BATCH_AXES``, as JAX's ``P(BATCH_AXES, "sp")``), sp the sequence,
tp the attention heads and MLP hidden units, ep the experts, pp the
layer stages (parallel/pipeline.py).  Where JAX's compiler inserts
the collectives a layout needs (GSPMD), the port writes each one, and
its gradient: the ``torch.autograd.Function`` wrappers at the end of
this module (:func:`copy_to`, :func:`reduce_from`, :func:`all_gather_ad`,
:func:`reduce_scatter_ad`, :func:`gather_replicated`; the pipeline's
point-to-point steps have their own, parallel/pipeline.py).  Their backward follows one convention: the
gradient of an activation every rank of an axis holds alike
(replicated) is the whole gradient on every one of those ranks, never
a share of it.

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

Every exchange is bounded by the mesh's deadline, :attr:`ProcessMesh.
timeout`: :func:`make_mesh` gives each axis group the timeout the
port's rendezvous gave the default group (``TPU_RENDEZVOUS_BARRIER_
TIMEOUT_S``), and on gloo a group's timeout bounds every wait on it,
the ring's hops included.  A peer that dies closes its sockets and
fails the exchange at once; a peer that is stopped or stuck keeps them
open and fails it at the deadline.  Either way this rank raises
:class:`MeshPeerError`, which names the axis, this rank's coordinates,
the peers' coordinates on the line and the deadline, so a killed or
wedged rank fails its survivors in-band.  Any other error (a bad
argument, a CUDA fault surfacing at a staging copy) is raised as it
is.  That holds for gloo.  On
NCCL the group's timeout drives torch's watchdog instead: under
torch's default ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` it reports the
collective that passed the deadline on stderr and ends the process, so
a survivor exits nonzero with no Python exception to catch.  That path
needs a card a rank and is untested here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import math
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .rendezvous import group_timeout

MESH_AXES = ("dp", "ep", "sp", "tp", "pp")

# Batch dimension is sharded over every data-like axis.
BATCH_AXES = ("dp", "ep")

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


def visible_chip_count(env: dict[str, str] | None = None) -> int:
    """How many chips the DRA claim made visible (the driver's
    contract): the entries of ``TPU_VISIBLE_CHIPS`` where a TPU claim
    set it, as the JAX function counts them; else the GPU UUIDs
    (``GPU-...``) of ``CUDA_VISIBLE_DEVICES``, which the port's plugin
    writes for an NVIDIA claim; else ``torch.cuda.device_count()``.
    ``env`` defaults to the process environment (an empty one too, as
    in the JAX function)."""
    env = env or dict(os.environ)
    chips = env.get("TPU_VISIBLE_CHIPS", "")
    if chips:
        return len([x for x in chips.split(",") if x != ""])
    uuids = [x for x in env.get("CUDA_VISIBLE_DEVICES", "").split(",")
             if x.strip().startswith("GPU-")]
    if uuids:
        return len(uuids)
    return torch.cuda.device_count()


def log2_int(n: int) -> int:
    """log2 of ``n``, which must be a power of two."""
    out = int(math.log2(n))
    assert 2 ** out == n, f"{n} is not a power of two"
    return out


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


def spec_axes(entry) -> tuple:
    """The mesh axes one ``PartitionSpec`` entry names, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_block(shape, spec, sizes: dict, coords: dict) -> list[list[int]]:
    """``[[start, stop], ...]``: the block of an array of ``shape`` laid
    out by ``spec`` that the mesh position ``coords`` holds, on a mesh
    of axis ``sizes``.  A dimension split over several axes is cut
    row-major over them.  A dimension that does not divide raises
    ``ValueError`` in the words JAX's ``device_put`` uses."""
    out = []
    spec = tuple(spec)
    for dim, n in enumerate(shape):
        axes = spec_axes(spec[dim]) if dim < len(spec) else ()
        parts, index = 1, 0
        for axis in axes:
            parts *= sizes[axis]
            index = index * sizes[axis] + coords[axis]
        if n % parts:
            raise ValueError(
                f"the sharding {PartitionSpec(*spec)} implies that the "
                f"global size of its dimension {dim} should be divisible "
                f"by {parts}, but it is equal to {n} (full shape: "
                f"{tuple(int(d) for d in shape)})")
        step = n // parts
        out.append([index * step, (index + 1) * step])
    return out


class MeshPeerError(RuntimeError):
    """A collective or exchange of the mesh failed: a peer on the line
    dropped its connection, or did not answer within the deadline."""

    def __init__(self, axis: str | None, coords: dict, peers: list,
                 deadline_s: float | None, cause: BaseException):
        self.axis, self.coords, self.peers = axis, coords, peers
        self.deadline_s = deadline_s
        where = "world" if axis is None else f"axis {axis!r}"
        deadline = ("torch's default" if deadline_s is None
                    else f"{deadline_s:g} s")
        super().__init__(
            f"mesh {where}: rank at {coords} lost its peers {peers} "
            f"(dropped connection, or no answer within the deadline of "
            f"{deadline}): {cause}")


#: what gloo's transport writes into the ``RuntimeError`` of a peer
#: that closed its connection or did not answer within the timeout
_GLOO_TRANSPORT = ("/gloo/transport/", "pair closure")


def _peer_lost(e: BaseException) -> bool:
    """Whether ``e`` from a collective means a peer was lost: one of
    torch's distributed errors, or gloo's transport failing."""
    return isinstance(e, dist.DistError) or (
        isinstance(e, RuntimeError)
        and any(mark in str(e) for mark in _GLOO_TRANSPORT))


class _Pending:
    """Receives of :meth:`ProcessMesh.exchange_start` in flight."""

    def __init__(self, mesh, axis, peers, works, bufs):
        self._mesh, self._axis, self._peers = mesh, axis, peers
        self._works, self._bufs = works, bufs

    def wait(self) -> list[torch.Tensor]:
        """The received tensors on the mesh's device, once every send
        and receive completed; raises :class:`MeshPeerError` when a peer
        is lost."""
        mesh = self._mesh
        with mesh._in_band(self._axis, self._peers):
            for work in self._works:
                # deadline: gloo bounds the wait by the group's timeout
                # (the mesh's); on NCCL it only orders the stream, and
                # the group's timeout drives torch's watchdog
                work.wait()
        return [b.to(mesh.device) for b in self._bufs]


class ProcessMesh:
    """The mesh as this process sees it: the spec, its device, its
    position, and one process group per axis of size > 1 (the ranks of
    its line along that axis, in coordinate order).  Built by
    :func:`make_mesh`.

    The collectives take the axis by name (``None``: the whole world)
    and are identities on an axis of size 1.  Each raises
    :class:`MeshPeerError` when a peer is lost (module docstring)."""

    def __init__(self, spec: MeshSpec, device: torch.device, rank: int,
                 groups: dict, lines: dict,
                 timeout: datetime.timedelta | None = None):
        self.spec = spec
        self.device = device
        self.rank = rank
        self.coords = mesh_coords(rank, spec)
        self._groups = groups
        self._lines = lines
        #: the deadline of every exchange (None: torch's default)
        self.timeout = timeout

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

    def _peers(self, axis: str | None, *coords: int) -> list:
        """The peers of this rank on ``axis`` (None: the world): their
        coordinates along the axis (global ranks on the world), those
        given or else every other one on the line."""
        if axis is None:
            return [f"rank {r}" for r in range(self.world_size)
                    if r != self.rank]
        return [f"{axis}={c}" for c in
                dict.fromkeys(coords or range(self.size(axis)))
                if c != self.index(axis)]

    @contextlib.contextmanager
    def _in_band(self, axis: str | None, peers: list | None = None):
        """Raise a lost peer inside (:func:`_peer_lost`) as
        :class:`MeshPeerError` against ``peers`` (default: the line's);
        any other error passes unchanged."""
        try:
            yield
        except RuntimeError as e:
            if not _peer_lost(e):
                raise
            raise MeshPeerError(
                axis, dict(self.coords),
                self._peers(axis) if peers is None else peers,
                None if self.timeout is None
                else self.timeout.total_seconds(), e) from e

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
        """This process's shard of a global ``[B, T, ...]`` batch, as
        JAX's ``P(BATCH_AXES, "sp")`` places it: the rows of its
        (dp, ep) block, row-major, the columns of its ``sp``
        coordinate.  Every tp and pp rank holds its block's whole
        rows."""
        b, t = x.shape[0], x.shape[1]
        bi, nb = 0, 1                     # row-major over BATCH_AXES
        for axis in BATCH_AXES:
            bi = bi * self.size(axis) + self.index(axis)
            nb *= self.size(axis)
        sp = self.size("sp")
        if b % nb or t % sp:
            raise ValueError(f"batch [B={b}, T={t}] does not split over "
                             f"dp x ep={nb} x sp={sp}")
        si = self.index("sp")
        return x[bi * (b // nb):(bi + 1) * (b // nb),
                 si * (t // sp):(si + 1) * (t // sp)]

    def all_reduce_(self, x: torch.Tensor, axis: str | None = None):
        """Sum ``x`` over ``axis`` (None: the world), in place."""
        if axis is not None and self.size(axis) == 1:
            return x
        wire = self._wire(x, axis)
        with self._in_band(axis):
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
        with self._in_band(axis):
            dist.all_gather(parts, wire, group=self.group(axis))
        return torch.cat(parts, dim=dim).to(x.device)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` [S, ...]: chunk j goes to coordinate j along ``axis``;
        the result's chunk i came from coordinate i."""
        if self.size(axis) == 1:
            return x
        wire = self._wire(x.contiguous(), axis)
        out = torch.empty_like(wire)
        with self._in_band(axis):
            dist.all_to_all_single(out, wire, group=self.group(axis))
        return out.to(x.device)

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int = 0):
        """Sum ``x`` over ``axis`` and keep this coordinate's chunk of
        the sum along ``dim`` (JAX's tiled ``psum_scatter``).  NCCL runs
        ``reduce_scatter_tensor``; a gloo group all-reduces and slices,
        which every torch version's gloo can do (its reduce-scatter
        came late)."""
        n = self.size(axis)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"scatter over {axis}={n}")
        i = self.index(axis)
        if dist.get_backend(self.group(axis)) == "gloo":
            total = self.all_reduce_(x.clone(), axis)
            return total.narrow(dim, i * (x.shape[dim] // n),
                                x.shape[dim] // n).contiguous()
        chunks = x.movedim(dim, 0).contiguous()
        out = torch.empty((chunks.shape[0] // n,) + chunks.shape[1:],
                          dtype=x.dtype, device=x.device)
        with self._in_band(axis):
            dist.reduce_scatter_tensor(out, chunks, group=self.group(axis))
        return out.movedim(0, dim).contiguous()

    def broadcast(self, x: torch.Tensor, axis: str, src: int):
        """Coordinate ``src``'s ``x`` on every process of the ``axis``
        line (a new tensor; ``x`` gives the shape and dtype elsewhere)."""
        if self.size(axis) == 1:
            return x
        wire = self._wire(x.contiguous(), axis)
        if wire is x:
            wire = x.clone()
        with self._in_band(axis):
            dist.broadcast(wire, self.line(axis)[src],
                           group=self.group(axis))
        return wire.to(x.device)

    def send(self, x: torch.Tensor, axis: str, to: int) -> None:
        """Send ``x`` to coordinate ``to`` along ``axis`` (blocking)."""
        wire = self._wire(x.contiguous(), axis)
        with self._in_band(axis, self._peers(axis, to)):
            dist.send(wire, self.line(axis)[to], group=self.group(axis))

    def recv(self, shape, dtype, axis: str, frm: int) -> torch.Tensor:
        """A tensor of ``shape``/``dtype`` from coordinate ``frm`` along
        ``axis``, on this mesh's device."""
        on = ("cpu" if self.host_staged(axis) else self.device)
        buf = torch.empty(shape, dtype=dtype, device=on)
        with self._in_band(axis, self._peers(axis, frm)):
            dist.recv(buf, self.line(axis)[frm], group=self.group(axis))
        return buf.to(self.device)

    def exchange_start(self, tensors, axis: str, send_to: int,
                       recv_from: int) -> _Pending:
        """Send ``tensors`` to coordinate ``send_to`` along ``axis`` and
        receive as many of the same shapes from ``recv_from``, in one
        ``batch_isend_irecv``; ``.wait()`` on the result returns the
        received tensors on this mesh's device."""
        if self.size(axis) == 1:
            return _Pending(self, axis, [], [], list(tensors))
        peers = self._peers(axis, send_to, recv_from)
        line = self.line(axis)
        group = self.group(axis)
        ops, bufs = [], []
        for x in tensors:
            wire = self._wire(x.contiguous(), axis)
            buf = torch.empty_like(wire)
            ops.append(dist.P2POp(dist.isend, wire, line[send_to], group))
            ops.append(dist.P2POp(dist.irecv, buf, line[recv_from], group))
            bufs.append(buf)
        with self._in_band(axis, peers):
            works = dist.batch_isend_irecv(ops)
        return _Pending(self, axis, peers, works, bufs)

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
    size, as JAX's ``make_mesh`` does.

    Every axis group takes the timeout ``parallel.rendezvous.initialize``
    gave the default group (``TPU_RENDEZVOUS_BARRIER_TIMEOUT_S``), the
    mesh's deadline.  Over a default group the port's rendezvous did
    not stand up, the groups take torch's default (30 minutes on gloo,
    10 on NCCL) and the mesh waits as long."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.rendezvous.initialize first")
    world = dist.get_world_size()
    spec = spec or MeshSpec(dp=world)
    if spec.num_devices != world:
        raise ValueError(f"mesh {spec} wants {spec.num_devices} devices, "
                         f"have {world} processes")
    dev = resolve_device(device)
    timeout = group_timeout()
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
            group = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                groups[axis], lines[axis] = group, ranks
    return ProcessMesh(spec, dev, rank, groups, lines, timeout)


# --------------------------------------------------------------------------
# Differentiable collectives
# --------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the axis
    (each rank's use of a replicated input is one part of it)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return mesh.all_reduce_(g.contiguous().clone(), axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """Sum of the axis's partial values forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim`` forward; the backward reduce-scatters the
    gradient (each rank's gradient of the gathered tensor is a part)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return mesh.reduce_scatter(g, axis, dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return mesh.reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return mesh.all_gather(g.contiguous(), axis, dim), None, None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` into a tensor every rank then uses alike;
    the backward keeps this rank's slice of the (whole) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim, x.shape[dim])
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, n = ctx.args
        return (g.narrow(dim, mesh.index(axis) * n, n).contiguous(), None,
                None, None)


def _axis_live(mesh, axis) -> bool:
    return mesh is not None and mesh.size(axis) > 1


def copy_to(x, mesh, axis: str):
    """``x`` as the input of work split over ``axis`` (Megatron's f):
    identity forward, all-reduce of the gradient backward."""
    return _CopyTo.apply(x, mesh, axis) if _axis_live(mesh, axis) else x


def reduce_from(x, mesh, axis: str):
    """The sum over ``axis`` of partial outputs (Megatron's g):
    all-reduce forward, identity backward."""
    return _ReduceFrom.apply(x, mesh, axis) if _axis_live(mesh, axis) else x


def all_gather_ad(x, mesh, axis: str, dim: int = 0):
    """Differentiable all-gather whose consumers are split over
    ``axis``: the backward is a reduce-scatter."""
    return (_AllGather.apply(x, mesh, axis, dim)
            if _axis_live(mesh, axis) else x)


def reduce_scatter_ad(x, mesh, axis: str, dim: int = 0):
    """Differentiable reduce-scatter: the backward is an all-gather."""
    return (_ReduceScatter.apply(x, mesh, axis, dim)
            if _axis_live(mesh, axis) else x)


def gather_replicated(x, mesh, axis: str, dim: int):
    """Differentiable all-gather into a replicated activation: the
    backward keeps this rank's slice of the gradient."""
    return (_GatherReplicated.apply(x, mesh, axis, dim)
            if _axis_live(mesh, axis) else x)


__all__ = ["BATCH_AXES", "MESH_AXES", "MeshPeerError", "MeshSpec", "P",
           "PartitionSpec", "ProcessMesh", "all_gather_ad", "copy_to",
           "gather_replicated", "log2_int", "make_mesh", "mesh_coords",
           "mesh_rank", "reduce_from", "reduce_scatter_ad", "spec_axes",
           "spec_block", "visible_chip_count"]
