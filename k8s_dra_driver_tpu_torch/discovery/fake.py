"""Hermetic fake discovery: a synthetic sysfs tree + env.

The port's copy of ``k8s_dra_driver_tpu/discovery/fake.py``.
``FakeHost(generation="h100", ...)`` writes an NVIDIA tree in place of
an accel tree, in one of the two forms the NVIDIA path reads
(``nvidia="procfs"``: PCI sysfs plus the driver's procfs entries;
``nvidia="driver"``: only ``/dev/nvidia*`` and the driver's libraries,
as on the H100's own machine, where the libraries are a stand-in built
from ``native/fakenvidia.cc``).  Its cards default to those the probe
of that machine recorded (``H100_PROBE``), then made-up ones.

Closes the reference's biggest testability gap (SURVEY §4: NVML is not
abstracted, so nothing touching enumeration is unit-testable).  Two
levels:

- ``FakeHost.materialize()`` writes a realistic ``/sys/class/accel`` +
  ``/dev`` tree into a temp dir and returns a real ``SysfsBackend``
  pointed at it — so the *production parser* is what tests exercise.
- ``StaticBackend`` returns a hand-built ``HostTopology`` directly, for
  tests that don't care about parsing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
from pathlib import Path

from ..utils import nativebuild
from .sysfs import (GOOGLE_PCI_VENDOR, LIBCUDA_SEARCH_PATHS, NVML_NAME,
                    NVIDIA_PCI_VENDOR, SysfsBackend)
from .topology import GENERATIONS, GenerationSpec, MeshShape
from .types import DiscoveryBackend, HostTopology


@dataclasses.dataclass(frozen=True)
class NvidiaCard:
    """One NVIDIA card of a fake tree."""

    minor: int
    uuid: str
    bus_id: str                     # sysfs form, e.g. "0000:9b:00.0"
    model: str = "NVIDIA H100 80GB HBM3"
    numa_node: int = 0


#: The H100s that a read-only probe of the card's machine saw, one a
#: call (NVIDIA H100 80GB HBM3, 700.00 W, driver 580.159.03): the minor
#: of ``nvidia-smi -q`` and its ``/dev/nvidia<minor>``, the CUDA
#: driver's UUID (its 16 bytes; torch's ``uuid``) and bus id (NVML's is
#: not supported there, nvidia-smi prints ``[N/A]``).  That machine
#: shows no PCI sysfs, so no NUMA node.
H100_PROBE = (
    NvidiaCard(minor=4, uuid="GPU-9d37ca28-6232-adb6-01f5-1a4c64926706",
               bus_id="0000:9b:00.0", numa_node=-1),
    NvidiaCard(minor=6, uuid="GPU-ef923520-42a5-e416-6022-f985c446c190",
               bus_id="0000:cb:00.0", numa_node=-1),
)

# bus ids of the made-up cards after the probe's (an eight-card host)
_MORE_BUSES = ("0000:18:00.0", "0000:2a:00.0", "0000:3a:00.0",
               "0000:5d:00.0", "0000:ab:00.0", "0000:db:00.0")


def h100_cards(n: int, hostname: str) -> tuple[NvidiaCard, ...]:
    """``n`` (at most 8) cards: the probe's, then made-up ones with the
    free minors from 0, UUIDs from the hostname, ascending bus ids."""
    if not 0 <= n <= len(H100_PROBE) + len(_MORE_BUSES):
        raise ValueError(f"a fake H100 host holds at most 8 cards, not {n}")
    cards = list(H100_PROBE[:n])
    used = {c.minor for c in cards}
    free = (m for m in range(64) if m not in used)
    for bus in _MORE_BUSES[:n - len(cards)]:
        h = hashlib.sha256(f"{hostname}/{bus}".encode()).hexdigest()
        cards.append(NvidiaCard(
            minor=next(free), bus_id=bus, numa_node=0,
            uuid=f"GPU-{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:32]}"))
    return tuple(cards)


def _information(card: NvidiaCard, with_uuid: bool) -> str:
    """The driver's ``/proc/driver/nvidia/gpus/<bus>/information``."""
    lines = [("Model", card.model), ("IRQ", "0")]
    if with_uuid:
        lines.append(("GPU UUID", card.uuid))
    lines += [("Video BIOS", "96.00.99.00.0d"), ("Bus Type", "PCIe"),
              ("DMA Size", "52 bits"), ("DMA Mask", "0xfffffffffffff"),
              ("Bus Location", card.bus_id),
              ("Device Minor", str(card.minor)), ("GPU Excluded", "No")]
    return "".join(f"{k}:\t {v}\n" for k, v in lines)


@dataclasses.dataclass
class FakeHost:
    """Description of a synthetic TPU host."""

    generation: str = "v5e"
    num_chips: int = 4
    hostname: str = "tpu-host-0"
    host_bounds: str = "2,2,1"
    # Multi-host slice identity; leave slice_id empty for single-host.
    slice_id: str = ""
    topology: str = ""          # e.g. "4x4"
    worker_id: int = 0
    worker_hostnames: tuple[str, ...] = ()
    with_libtpu: bool = True
    with_serials: bool = True
    # NVIDIA trees (generation "h100"): which form, and the cards
    # (default: h100_cards(num_chips, hostname)); with_serials=False
    # leaves the UUID line out of each information file, with_libtpu
    # the driver's libcuda.so.1 out of the tree.
    nvidia: str = "procfs"
    cards: tuple[NvidiaCard, ...] = ()

    @property
    def gen(self) -> GenerationSpec:
        return GENERATIONS[self.generation]

    def env(self) -> dict[str, str]:
        env = {
            "HOSTNAME": self.hostname,
            "TPU_CHIPS_PER_HOST_BOUNDS": self.host_bounds,
            "TPU_ACCELERATOR_TYPE": f"{self.generation}-{self.num_chips}",
        }
        if self.slice_id:
            env["TPU_SLICE_ID"] = self.slice_id
            env["TPU_TOPOLOGY"] = self.topology
            env["TPU_WORKER_ID"] = str(self.worker_id)
            env["TPU_WORKER_HOSTNAMES"] = ",".join(self.worker_hostnames)
        return env

    def nvidia_cards(self) -> tuple[NvidiaCard, ...]:
        return self.cards or h100_cards(self.num_chips, self.hostname)

    def _materialize_nvidia(self, root: Path) -> None:
        dev = root / "dev"
        dev.mkdir(parents=True, exist_ok=True)
        for name in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"):
            (dev / name).write_text("")
        cards = self.nvidia_cards()
        for c in cards:
            (dev / f"nvidia{c.minor}").write_text("")
        libdir = root / Path(LIBCUDA_SEARCH_PATHS[0]).parent
        if self.nvidia == "procfs":
            for c in cards:
                pci = root / "sys/bus/pci/devices" / c.bus_id
                pci.mkdir(parents=True, exist_ok=True)
                (pci / "vendor").write_text(NVIDIA_PCI_VENDOR + "\n")
                (pci / "class").write_text("0x030200\n")
                (pci / "numa_node").write_text(f"{c.numa_node}\n")
                info = root / "proc/driver/nvidia/gpus" / c.bus_id
                info.mkdir(parents=True, exist_ok=True)
                (info / "information").write_text(
                    _information(c, self.with_serials))
            if self.with_libtpu:
                libdir.mkdir(parents=True, exist_ok=True)
                (libdir / "libcuda.so.1").write_text("fake libcuda")
        elif self.nvidia == "driver":
            # the probed machine also shows /dev/nvidia0, which is no card
            (dev / "nvidia0").write_text("")
            if self.with_libtpu:
                lib = nativebuild.ensure_built(
                    nativebuild.NATIVE_DIR / "fakenvidia.cc",
                    nativebuild.BUILD_DIR / "libfakenvidia.so", None,
                    RuntimeError)
                libdir.mkdir(parents=True, exist_ok=True)
                for name in ("libcuda.so.1", NVML_NAME):
                    shutil.copyfile(lib, libdir / name)
                (libdir / "fake-gpus.txt").write_text("".join(
                    f"{c.minor}|{c.uuid}|{c.bus_id.upper()}|{c.model}\n"
                    for c in sorted(cards, key=lambda c: c.bus_id)))
        else:
            raise ValueError(f"unknown NVIDIA tree form {self.nvidia!r}")

    def materialize(self, root: Path) -> SysfsBackend:
        """Write the sysfs/devfs tree under ``root`` and return a backend."""
        root = Path(root)
        if self.generation == "h100":
            self._materialize_nvidia(root)
            return SysfsBackend(host_root=str(root), env=self.env(),
                                hostname=self.hostname)
        accel = root / "sys/class/accel"
        accel.mkdir(parents=True, exist_ok=True)
        (root / "dev/vfio").mkdir(parents=True, exist_ok=True)
        for i in range(self.num_chips):
            # Real sysfs uses a symlink into /sys/devices/pci...; a plain
            # dir named like the PCI address keeps realpath() behaviour.
            pci_addr = f"0000:{i:02x}:00.0"
            pci_dir = root / "sys/devices" / pci_addr
            pci_dir.mkdir(parents=True, exist_ok=True)
            (pci_dir / "vendor").write_text(GOOGLE_PCI_VENDOR + "\n")
            (pci_dir / "device").write_text(self.gen.pci_ids[0] + "\n")
            (pci_dir / "numa_node").write_text("0\n")
            if self.with_serials:
                (pci_dir / "serial_number").write_text(
                    f"{self.hostname}-serial-{i}\n")
            link = accel / f"accel{i}" / "device"
            link.parent.mkdir(parents=True, exist_ok=True)
            if not link.exists():
                link.symlink_to(pci_dir)
            (root / "dev" / f"accel{i}").write_text("")  # stand-in node
        if self.with_libtpu:
            lib = root / "usr/lib/libtpu.so"
            lib.parent.mkdir(parents=True, exist_ok=True)
            lib.write_text("fake libtpu")
        # Persist the libtpu env contract in the tree: a containerized
        # plugin probing this tree as --driver-root (kind acceptance)
        # has no TPU_* in its own environment, so SysfsBackend overlays
        # this file — the hermetic stand-in for GKE's instance metadata.
        (root / "tpu-env.json").write_text(json.dumps(self.env(),
                                                      sort_keys=True))
        return SysfsBackend(host_root=str(root), env=self.env(),
                            hostname=self.hostname)


def fake_slice_hosts(num_hosts: int, topology: str = "4x4",
                     generation: str = "v5e",
                     slice_id: str = "slice-a") -> list[FakeHost]:
    """A gang of FakeHosts forming one multi-host pod slice."""
    topo = MeshShape.parse(topology)
    bounds = MeshShape.parse("2x2")
    chips_per_host = bounds.num_chips
    assert topo.num_chips == num_hosts * chips_per_host, (
        f"{topology} needs {topo.num_chips // chips_per_host} hosts, "
        f"got {num_hosts}")
    names = tuple(f"{slice_id}-w{i}" for i in range(num_hosts))
    return [
        FakeHost(generation=generation, num_chips=chips_per_host,
                 hostname=names[i], host_bounds="2,2,1", slice_id=slice_id,
                 topology=topology, worker_id=i, worker_hostnames=names)
        for i in range(num_hosts)
    ]


class StaticBackend(DiscoveryBackend):
    def __init__(self, topo: HostTopology):
        self._topo = topo
        # tests flip entries here to simulate chip failures
        self.unhealthy: dict[int, str] = {}

    def enumerate(self) -> HostTopology:
        return self._topo

    def health(self, expected=None) -> dict[int, str]:
        return dict(self.unhealthy)
