"""Accelerator generation and ICI-topology model.

The port's copy of ``k8s_dra_driver_tpu/discovery/topology.py`` with one
more entry: the NVIDIA H100 80GB HBM3 (``"h100"``) beside the four TPU
generations.  This is the TPU-native analog of the reference's NVML device model
(reference cmd/nvidia-dra-plugin/nvlib.go:202-313 getGpuInfo /
getMigDevices): instead of CUDA compute capability, MIG profiles and
memory-slice placements, the scheduling-relevant hardware facts for a TPU
are its generation, cores per chip, HBM, and — crucially — its ICI
(inter-chip interconnect) coordinates, because contiguous ICI meshes are
the TPU analog of NVLink cliques / MIG placement slots.

Everything here is pure data; enumeration lives in the backends
(sysfs.py / shim.py / fake.py).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class GenerationSpec:
    """Static facts about one TPU generation."""

    name: str                 # canonical short name, e.g. "v5e"
    product_name: str         # marketing-ish name used as a CEL-selectable attribute
    cores_per_chip: int
    hbm_bytes_per_chip: int
    # ICI mesh dimensionality of a pod built from this generation (2 or 3).
    ici_dims: int
    # Default chips-per-host bounds (x, y, z).  Hosts of the same pod tile
    # the pod mesh with this shape.
    default_host_bounds: tuple[int, int, int]
    # PCI vendor:device ids that identify this generation in sysfs.
    pci_ids: tuple[str, ...] = ()


GiB = 1024 ** 3
MiB = 1024 ** 2

# Public per-generation facts (core counts / HBM from Cloud TPU docs).
# The H100's are the card's own, as its machine reports them: the
# product name is its model string ("NVIDIA H100 80GB HBM3")
# lower-cased with dashes (sysfs.nvidia_product_name), the memory
# nvidia-smi's memory.total (81559 MiB), one core (MIG is not
# modelled), a 2-D placement grid, one card a host by default.  No PCI
# device id: the card's machine hides PCI sysfs, so none was read, and
# the NVIDIA path matches a card by its model string instead.
GENERATIONS: dict[str, GenerationSpec] = {
    "v4": GenerationSpec(
        name="v4", product_name="tpu-v4", cores_per_chip=2,
        hbm_bytes_per_chip=32 * GiB, ici_dims=3,
        default_host_bounds=(2, 2, 1), pci_ids=("0x005e",),
    ),
    "v5e": GenerationSpec(
        name="v5e", product_name="tpu-v5-lite", cores_per_chip=1,
        hbm_bytes_per_chip=16 * GiB, ici_dims=2,
        default_host_bounds=(2, 2, 1), pci_ids=("0x0063",),
    ),
    "v5p": GenerationSpec(
        name="v5p", product_name="tpu-v5p", cores_per_chip=2,
        hbm_bytes_per_chip=95 * GiB, ici_dims=3,
        default_host_bounds=(2, 2, 1), pci_ids=("0x0062",),
    ),
    "v6e": GenerationSpec(
        name="v6e", product_name="tpu-v6e", cores_per_chip=1,
        hbm_bytes_per_chip=32 * GiB, ici_dims=2,
        default_host_bounds=(2, 2, 1), pci_ids=("0x006f",),
    ),
    "h100": GenerationSpec(
        name="h100", product_name="nvidia-h100-80gb-hbm3",
        cores_per_chip=1, hbm_bytes_per_chip=81559 * MiB, ici_dims=2,
        default_host_bounds=(1, 1, 1),
    ),
}


@dataclasses.dataclass(frozen=True, order=True)
class ICICoord:
    """Absolute coordinate of a chip in its pod-slice ICI mesh."""

    x: int
    y: int
    z: int = 0

    def as_tuple(self) -> tuple[int, int, int]:
        return (self.x, self.y, self.z)

    def __str__(self) -> str:  # "x,y,z" — used in device attributes
        return f"{self.x},{self.y},{self.z}"

    @classmethod
    def parse(cls, s: str) -> "ICICoord":
        parts = [int(p) for p in s.split(",")]
        while len(parts) < 3:
            parts.append(0)
        if len(parts) != 3:
            raise ValueError(f"bad ICI coordinate {s!r}")
        return cls(*parts)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """An axis-aligned box of chips in the ICI mesh, e.g. 2x2x1."""

    x: int
    y: int
    z: int = 1

    @property
    def num_chips(self) -> int:
        return self.x * self.y * self.z

    def __str__(self) -> str:
        if self.z == 1:
            return f"{self.x}x{self.y}"
        return f"{self.x}x{self.y}x{self.z}"

    @classmethod
    def parse(cls, s: str) -> "MeshShape":
        parts = [int(p) for p in s.lower().split("x")]
        if not 2 <= len(parts) <= 3 or any(p < 1 for p in parts):
            raise ValueError(f"bad mesh shape {s!r}")
        while len(parts) < 3:
            parts.append(1)
        return cls(*parts)

    def offsets(self) -> Iterator[tuple[int, int, int]]:
        """All (dx, dy, dz) offsets inside the box, x-fastest."""
        for dz, dy, dx in itertools.product(
                range(self.z), range(self.y), range(self.x)):
            yield (dx, dy, dz)

    def placements(self, bounds: "MeshShape") -> Iterator[ICICoord]:
        """All origins at which this shape fits inside ``bounds``, aligned
        to its own size (non-overlapping tiling origins).

        Alignment mirrors how MIG placements come pre-quantised from the
        hardware (reference nvlib.go:268-274 GetPossiblePlacements): a 2x2
        slice may start only at even coordinates, which keeps the set of
        published slice devices small and guarantees that the overlap
        capacities (devicemodel/slices.py) cleanly nest.
        """
        if self.x > bounds.x or self.y > bounds.y or self.z > bounds.z:
            return
        for ox in range(0, bounds.x - self.x + 1, self.x):
            for oy in range(0, bounds.y - self.y + 1, self.y):
                for oz in range(0, bounds.z - self.z + 1, self.z):
                    yield ICICoord(ox, oy, oz)


def standard_slice_shapes(gen: GenerationSpec, bounds: MeshShape) -> list[MeshShape]:
    """Power-of-two slice shapes that fit within ``bounds``.

    These are the pre-enumerated allocatable slice shapes (SURVEY §7.3):
    1x1 is the whole-chip device itself, so shapes start at 2 chips.
    For 2D generations (v5e/v6e) shapes grow x then y; for 3D (v4/v5p)
    z as well.  Mirrors the role of the MIG profile list
    (reference nvlib.go:315-414) as "what partitions exist at all".
    """
    shapes: list[MeshShape] = []
    dims = [1, 2, 4, 8, 16]
    for x in dims:
        for y in dims:
            zs = dims if gen.ici_dims == 3 else [1]
            for z in zs:
                s = MeshShape(x, y, z)
                if s.num_chips < 2:
                    continue
                if s.x <= bounds.x and s.y <= bounds.y and s.z <= bounds.z:
                    # keep near-square shapes (x within 2x of y), the shapes
                    # Cloud TPU actually offers (2x2, 2x4, 4x4, 4x8, ...).
                    if s.y > s.x * 2 or s.x > s.y * 2:
                        continue
                    shapes.append(s)
    shapes.sort(key=lambda s: (s.num_chips, s.x, s.y, s.z))
    return shapes
