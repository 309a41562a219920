"""Discovery records: what one node knows about its accelerators.

The port's copy of ``k8s_dra_driver_tpu/discovery/types.py``; the field
names stay the JAX package's, so records of both packages compare field
by field.  On an NVIDIA host a chip is one card: ``index`` is its
device minor (``/dev/nvidia<minor>``), ``uuid`` its ``GPU-...`` UUID,
and ``HostTopology.libtpu_path`` holds the host path of the driver's
``libcuda.so.1``.  The TPU analog of the reference's ``GpuInfo``/``MigDeviceInfo``
(reference cmd/nvidia-dra-plugin/deviceinfo.go:30-96): plain records
produced by a discovery backend, consumed by the device model.
"""

from __future__ import annotations

import dataclasses

from .topology import GenerationSpec, ICICoord, MeshShape


@dataclasses.dataclass(frozen=True)
class ChipInfo:
    """One physical TPU chip on this host."""

    index: int                     # host-local index, matches /dev/accel<index>
                                   # (NVIDIA: the device minor, /dev/nvidia<index>)
    uuid: str                      # stable id, e.g. "TPU-v5e-4fda.../0"
    generation: GenerationSpec
    coord: ICICoord                # absolute coordinate in the pod-slice mesh
    dev_paths: tuple[str, ...]     # device nodes to inject, e.g. ("/dev/accel0",)
    pci_address: str = ""
    numa_node: int = -1

    @property
    def cores(self) -> int:
        return self.generation.cores_per_chip

    @property
    def hbm_bytes(self) -> int:
        return self.generation.hbm_bytes_per_chip


@dataclasses.dataclass(frozen=True)
class SliceMembership:
    """This host's identity within a multi-host TPU pod slice.

    The analog of the reference's IMEX-domain node label
    ``nvidia.com/gpu.imex-domain=<domain>.<clique>``
    (reference cmd/nvidia-dra-controller/imex.go:217-305): it is the fact
    the controller aggregates across nodes to publish gang resources.
    """

    slice_id: str                  # e.g. "projects/p/zones/z/slices/my-slice"
    topology: MeshShape            # full slice topology, e.g. 4x4
    worker_id: int                 # this host's worker index within the slice
    num_workers: int
    host_bounds: MeshShape         # chips-per-host box, e.g. 2x2
    coordinator_address: str = ""  # host:port of worker 0, if known


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """Everything discovery learned about this host."""

    hostname: str
    chips: tuple[ChipInfo, ...]
    libtpu_path: str = ""                 # host path of libtpu.so to mount
                                          # (NVIDIA: of libcuda.so.1)
    slice: SliceMembership | None = None  # None for single-host nodes

    @property
    def generation(self) -> GenerationSpec | None:
        return self.chips[0].generation if self.chips else None

    @property
    def host_bounds(self) -> MeshShape:
        if self.slice is not None:
            return self.slice.host_bounds
        if not self.chips:
            return MeshShape(0, 0, 0)
        xs = {c.coord.x for c in self.chips}
        ys = {c.coord.y for c in self.chips}
        zs = {c.coord.z for c in self.chips}
        return MeshShape(len(xs), len(ys), len(zs))

    def chip_by_index(self, index: int) -> ChipInfo:
        for c in self.chips:
            if c.index == index:
                return c
        raise KeyError(f"no chip with index {index}")


class DiscoveryBackend:
    """Interface every discovery backend implements.

    Defined as an interface from day one (unlike the reference, which
    constructs its concrete NVML wrapper directly and is therefore
    untestable without hardware — SURVEY §4) so the fake backend can stand
    in hermetically.
    """

    def enumerate(self) -> HostTopology:
        raise NotImplementedError

    def health(self, expected=None) -> dict[int, str]:
        """Chip index -> failure reason, for UNHEALTHY chips only.

        ``expected`` is the boot-time enumerated index set: chips in
        it that the backend can no longer observe at all must be
        reported failed (surprise removal erases the sysfs entry, not
        just the attributes).  {} means every expected chip is
        serviceable.  Backends that cannot observe health (static
        fixtures) inherit this default.  The reference has no health
        surface at all — an unhealthy GPU stays published until an
        operator intervenes; here the plugin polls this and
        republishes ResourceSlices without failed chips
        (plugin/health.py).
        """
        return {}
