"""Sysfs/devfs/env discovery backend: TPU chips and NVIDIA cards.

The port's copy of ``k8s_dra_driver_tpu/discovery/sysfs.py``.  The
accel-class path is the JAX package's, unchanged.  Beside it, the
NVIDIA path (``_nvidia_cards``) finds a host's cards in one of two ways:

- **procfs**: PCI devices of vendor ``0x10de`` and class ``0x03xxxx``
  under ``/sys/bus/pci/devices``, each named by the driver's
  ``/proc/driver/nvidia/gpus/<bus>/information`` (``Device Minor``,
  ``GPU UUID``, ``Model``).  A card without that file is not bound to
  the driver (no minor, no model) and is skipped; one whose UUID line
  is missing or not a ``GPU-`` UUID takes the JAX digest rule.
- **driver**: where PCI sysfs shows no NVIDIA device (a sandboxed
  container, as on the H100's own machine: no ``/sys/bus/pci``, no
  ``/proc/driver/nvidia/gpus``, only ``/dev/nvidia*`` and the driver's
  libraries) but ``/dev/nvidiactl`` exists, the driver's own libraries
  name the cards: NVML (``libnvidia-ml.so.1``, beside ``libcuda.so.1``)
  gives each card's minor and UUID, the CUDA driver (``libcuda.so.1``)
  the PCI bus id and name of the device with that UUID.  NVML's own PCI
  query is not supported on that machine.

Either way a card's ``index`` is its device minor, its node
``/dev/nvidia<minor>``, its coordinate ``(k, 0, 0)`` for its rank k in
minor order, and it carries no slice membership; its generation is the
one whose ``product_name`` is its model string lower-cased with dashes.
A host showing both accel-class chips and NVIDIA cards is refused.

The TPU-native replacement for NVML enumeration (reference
cmd/nvidia-dra-plugin/nvlib.go:111-313): instead of dlopen'ing
libnvidia-ml, TPU chips are visible as Linux accel devices —
``/sys/class/accel/accel<i>`` + ``/dev/accel<i>`` — and the slice/ICI
topology comes from the libtpu environment contract
(``TPU_CHIPS_PER_HOST_BOUNDS``, ``TPU_WORKER_ID``, ...) that GKE/GCE set
on TPU VMs.  No native library is required for enumeration; the optional
C++ shim (native/tpudiscovery.cc) covers hosts where sysfs attributes are
incomplete.

The ``host_root`` parameter plays the role of the reference's
containerized driver-root resolution (reference
cmd/nvidia-dra-plugin/root.go:25-109): when the plugin runs inside a pod
with the host filesystem mounted at e.g. ``/host``, all probing happens
under that prefix while the *published* device paths stay host-absolute.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
from pathlib import Path

from .topology import GENERATIONS, GenerationSpec, ICICoord, MeshShape
from .types import ChipInfo, DiscoveryBackend, HostTopology, SliceMembership

GOOGLE_PCI_VENDOR = "0x1ae0"

# Well-known host locations of libtpu, probed in order (findFile analog,
# reference root.go:92-109).
LIBTPU_SEARCH_PATHS = (
    "usr/lib/libtpu.so",
    "usr/local/lib/libtpu.so",
    "lib/libtpu.so",
    "home/kubernetes/bin/libtpu.so",
)

NVIDIA_PCI_VENDOR = "0x10de"

# Host locations of the NVIDIA driver's libcuda.so.1, probed in order
# (the LIBTPU_SEARCH_PATHS analog): Debian/Ubuntu multiarch (where the
# H100's machine has it), the NVIDIA container toolkit's mount, then
# lib64 and lib.  NVML is looked for beside the one found.
LIBCUDA_SEARCH_PATHS = (
    "usr/lib/x86_64-linux-gnu/libcuda.so.1",
    "usr/local/nvidia/lib64/libcuda.so.1",
    "usr/lib64/libcuda.so.1",
    "usr/lib/libcuda.so.1",
)
NVML_NAME = "libnvidia-ml.so.1"

_GPU_UUID = re.compile(r"GPU-[0-9a-fA-F]{8}(-[0-9a-fA-F]{4}){3}-[0-9a-fA-F]{12}")


def _read(path: Path) -> str | None:
    try:
        return path.read_text().strip()
    except OSError:
        return None


def _accel_index(name: str) -> int | None:
    """Chip index from an accel-class entry name, or None if the entry
    is not a chip.  Non-numeric suffixes (vendor entries like
    "accel0_vfio") must be skipped, not raise: a ValueError here would
    abort whole-tree enumeration and freeze the health probe at its
    last known state (enumeration and health share this filter)."""
    if not name.startswith("accel"):
        return None
    suffix = name.removeprefix("accel")
    if not suffix.isdigit() and suffix != "":
        return None
    return int(suffix or 0)


# Opt-in for reading a tree-carried env contract. Deliberately NOT
# inferred from the driver root: production runs with --driver-root
# /host, and a stray host /tpu-env.json must never be able to override
# the node's authoritative instance-metadata env. The kind acceptance
# install (fake trees) sets this via the chart's
# kubeletPlugin.allowEnvFile value.
ENV_FILE_FLAG = "TPU_DISCOVERY_ENV_FILE"
ENV_FILE_NAME = "tpu-env.json"


def load_env_overlay(root: Path | str,
                     base_env: dict[str, str]) -> dict[str, str]:
    """Env contract persisted in a (fake) host tree, gated on the
    explicit ``TPU_DISCOVERY_ENV_FILE`` opt-in; shared by the sysfs
    and native backends so both enumerate identical topologies."""
    if base_env.get(ENV_FILE_FLAG, "").lower() not in ("1", "true"):
        return {}
    env_file = Path(root) / ENV_FILE_NAME
    if not env_file.is_file():
        return {}
    try:
        overlay = json.loads(env_file.read_text())
    except (OSError, ValueError):
        return {}
    if not isinstance(overlay, dict):
        return {}
    return {str(k): str(v) for k, v in overlay.items()}


def find_libcuda(root: Path) -> str | None:
    """The first of ``LIBCUDA_SEARCH_PATHS`` present under ``root``."""
    return next((rel for rel in LIBCUDA_SEARCH_PATHS
                 if (root / rel).is_file()), None)


def nvidia_product_name(model: str) -> str:
    """A card's product name: its model string lower-cased, words
    joined by dashes ("NVIDIA H100 80GB HBM3" -> "nvidia-h100-80gb-hbm3")."""
    return "-".join(model.lower().split())


def normalize_bus_id(bus_id: str) -> str:
    """A PCI bus id in sysfs form: a 4-digit domain, lower case.
    ``nvidia-smi`` prints an 8-digit domain ("00000000:9B:00.0"), the
    CUDA driver upper-case hex ("0000:9B:00.0")."""
    domain, _, rest = bus_id.strip().partition(":")
    return f"{int(domain, 16):04x}:{rest.lower()}"


def _information(path: Path) -> dict[str, str] | None:
    """``Key: value`` lines of a driver ``information`` file."""
    raw = _read(path)
    if raw is None:
        return None
    out = {}
    for line in raw.splitlines():
        key, sep, value = line.partition(":")
        if sep:
            out[key.strip()] = value.strip()
    return out


def _nvidia_pci(root: Path) -> list[Path]:
    """NVIDIA display-class PCI devices (vendor 0x10de, class 0x03xxxx),
    in bus-id order."""
    base = root / "sys/bus/pci/devices"
    if not base.is_dir():
        return []
    return [d for d in sorted(base.iterdir(), key=lambda d: d.name)
            if (_read(d / "vendor") or "").lower() == NVIDIA_PCI_VENDOR
            and (_read(d / "class") or "").lower().startswith("0x03")]


def _procfs_minor(root: Path, bus: str) -> tuple[int, dict] | None:
    info = _information(root / "proc/driver/nvidia/gpus" / bus
                        / "information")
    minor = (info or {}).get("Device Minor", "")
    return (int(minor), info) if minor.isdigit() else None


def _nvidia_health(root: Path, expected) -> dict[int, str]:
    """A card is failed when its ``/dev/nvidia<minor>`` node is missing
    or, on a procfs host, its PCI device (or the driver's entry for it)
    has vanished while its index is expected.  A driver-path host shows
    no PCI device: the node is what can be observed there."""
    procfs = (root / "proc/driver/nvidia/gpus").is_dir()
    present = set()
    if procfs:
        for d in _nvidia_pci(root):
            got = _procfs_minor(root, d.name)
            if got is not None:
                present.add(got[0])
    out: dict[int, str] = {}
    for idx in sorted(present | set(expected or ())):
        node = f"/dev/nvidia{idx}"
        if not (root / node[1:]).exists():
            out[idx] = f"device node {node} missing"
        elif procfs and idx not in present:
            out[idx] = f"PCI device of {node} vanished"
    return out


def driver_cards(libcuda: Path, nvml: Path) -> list[tuple[int, str, str, str]]:
    """(minor, uuid, bus id, name) of every card the driver's libraries
    report, in NVML's index order: NVML's minor and UUID, the CUDA
    driver's bus id and name for that UUID.  Raises ``RuntimeError``
    when a call fails or the two libraries do not name the same
    cards."""
    cu = ctypes.CDLL(str(libcuda))
    nv = ctypes.CDLL(str(nvml))
    i, u, p = ctypes.c_int, ctypes.c_uint, ctypes.POINTER
    for name, args in (("cuInit", [u]), ("cuDeviceGetCount", [p(i)]),
                       ("cuDeviceGet", [p(i), i]),
                       ("cuDeviceGetUuid", [ctypes.c_char_p, i]),
                       ("cuDeviceGetPCIBusId", [ctypes.c_char_p, i, i]),
                       ("cuDeviceGetName", [ctypes.c_char_p, i, i])):
        getattr(cu, name).argtypes, getattr(cu, name).restype = args, i
    for name, args in (("nvmlInit_v2", []), ("nvmlShutdown", []),
                       ("nvmlDeviceGetCount_v2", [p(u)]),
                       ("nvmlDeviceGetHandleByIndex_v2",
                        [u, p(ctypes.c_void_p)]),
                       ("nvmlDeviceGetMinorNumber",
                        [ctypes.c_void_p, p(u)]),
                       ("nvmlDeviceGetUUID",
                        [ctypes.c_void_p, ctypes.c_char_p, u])):
        getattr(nv, name).argtypes, getattr(nv, name).restype = args, i

    def ok(rc: int, call: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{call} failed: {rc}")

    ok(cu.cuInit(0), "cuInit")
    n = i()
    ok(cu.cuDeviceGetCount(ctypes.byref(n)), "cuDeviceGetCount")
    devices = {}
    for ordinal in range(n.value):
        dev = i()
        ok(cu.cuDeviceGet(ctypes.byref(dev), ordinal), "cuDeviceGet")
        raw = ctypes.create_string_buffer(16)
        ok(cu.cuDeviceGetUuid(raw, dev), "cuDeviceGetUuid")
        h = raw.raw.hex()
        uuid = f"GPU-{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"
        bus = ctypes.create_string_buffer(64)
        ok(cu.cuDeviceGetPCIBusId(bus, 64, dev), "cuDeviceGetPCIBusId")
        name = ctypes.create_string_buffer(256)
        ok(cu.cuDeviceGetName(name, 256, dev), "cuDeviceGetName")
        devices[uuid] = (normalize_bus_id(bus.value.decode()),
                         name.value.decode())
    ok(nv.nvmlInit_v2(), "nvmlInit_v2")
    try:
        count = u()
        ok(nv.nvmlDeviceGetCount_v2(ctypes.byref(count)),
           "nvmlDeviceGetCount_v2")
        cards = []
        for index in range(count.value):
            handle, minor = ctypes.c_void_p(), u()
            ok(nv.nvmlDeviceGetHandleByIndex_v2(index,
                                                ctypes.byref(handle)),
               "nvmlDeviceGetHandleByIndex_v2")
            ok(nv.nvmlDeviceGetMinorNumber(handle, ctypes.byref(minor)),
               "nvmlDeviceGetMinorNumber")
            uuid = ctypes.create_string_buffer(96)
            ok(nv.nvmlDeviceGetUUID(handle, uuid, 96), "nvmlDeviceGetUUID")
            cards.append((minor.value, uuid.value.decode()))
    finally:
        nv.nvmlShutdown()
    if sorted(u for _, u in cards) != sorted(devices):
        raise RuntimeError(f"NVML names {len(cards)} cards, the CUDA "
                           f"driver {len(devices)}: not the same UUIDs")
    return [(m, uuid, *devices[uuid]) for m, uuid in cards]


#: sysfs health attribute values treated as serviceable
_HEALTHY_VALUES = ("", "ok", "alive", "healthy", "good")


def sysfs_health(root: Path | str, expected=None) -> dict[int, str]:
    """Unhealthy chips from observable node state under ``root``.

    A chip is failed when its ``/dev/accel<i>`` node has vanished
    (driver unbind, PCIe drop), its sysfs ``device/health`` attribute
    reports a non-ok value (the accel-class convention; absent
    attribute = no health reporting = healthy), or — given
    ``expected``, the boot-time enumerated chip indices — its whole
    ``/sys/class/accel/accel<i>`` entry is gone (surprise removal
    deletes the class device along with the node, so a live-dir scan
    alone would report the dead chip healthy).

    Shared by the sysfs and native discovery backends: the native shim
    enumerates through C, but health is a per-poll sysfs observation
    either way.  On an NVIDIA host (``/dev/nvidiactl`` present) the
    NVIDIA rules of ``_nvidia_health`` apply instead.
    """
    root = Path(root)
    if (root / "dev/nvidiactl").exists():
        return _nvidia_health(root, expected)
    out: dict[int, str] = {}
    base = root / "sys/class/accel"
    present: set[int] = set()
    if base.is_dir():
        for d in sorted(base.iterdir()):
            idx = _accel_index(d.name)
            if idx is None:
                continue
            present.add(idx)
            if not (root / "dev" / d.name).exists():
                out[idx] = f"device node /dev/{d.name} missing"
                continue
            raw = _read(d / "device" / "health")
            if raw is not None and \
                    raw.strip().lower() not in _HEALTHY_VALUES:
                out[idx] = f"sysfs health: {raw.strip()}"
    for idx in set(expected or ()) - present:
        out[idx] = f"sysfs entry /sys/class/accel/accel{idx} vanished"
    return out


def parse_bounds(s: str) -> MeshShape:
    """Parse "2,2,1"-style bounds env values."""
    parts = [int(p) for p in s.split(",")]
    if not 1 <= len(parts) <= 3 or any(p < 1 for p in parts):
        raise ValueError(f"bad bounds {s!r}")
    while len(parts) < 3:
        parts.append(1)
    return MeshShape(*parts)


def host_origin(worker_id: int, host_bounds: MeshShape,
                topology: MeshShape) -> ICICoord:
    """Absolute mesh origin of a worker's host box within the slice.

    Hosts tile the slice topology in x-fastest order, the same order
    libtpu assigns worker ids.
    """
    hx = max(topology.x // host_bounds.x, 1)
    hy = max(topology.y // host_bounds.y, 1)
    ox = worker_id % hx
    oy = (worker_id // hx) % hy
    oz = worker_id // (hx * hy)
    return ICICoord(ox * host_bounds.x, oy * host_bounds.y,
                    oz * host_bounds.z)


class SysfsBackend(DiscoveryBackend):
    def __init__(self, host_root: str = "/",
                 env: dict[str, str] | None = None,
                 hostname: str | None = None):
        self.root = Path(host_root)
        if env is None:
            env = dict(os.environ)
            env.update(load_env_overlay(self.root, env))
        self.env = env
        self.hostname = hostname or self.env.get("HOSTNAME") or os.uname().nodename

    # -- pieces -----------------------------------------------------------

    def _accel_dirs(self) -> list[Path]:
        base = self.root / "sys/class/accel"
        if not base.is_dir():
            return []
        return sorted((d for d in base.iterdir()
                       if _accel_index(d.name) is not None),
                      key=lambda d: _accel_index(d.name))

    def _generation_for(self, device_dir: Path) -> GenerationSpec | None:
        vendor = _read(device_dir / "vendor")
        if vendor is not None and vendor.lower() != GOOGLE_PCI_VENDOR:
            return None
        dev_id = (_read(device_dir / "device") or "").lower()
        for gen in GENERATIONS.values():
            if dev_id in gen.pci_ids:
                return gen
        # Fall back to the env-declared accelerator type so unknown PCI ids
        # (new steppings) still enumerate.
        decl = self.env.get("TPU_ACCELERATOR_TYPE", "")
        for gen in GENERATIONS.values():
            if decl.startswith(gen.name) or decl.startswith(gen.product_name):
                return gen
        return None

    def _slice_membership(self) -> SliceMembership | None:
        topo_s = self.env.get("TPU_TOPOLOGY") or self.env.get("TPU_HOST_BOUNDS")
        slice_id = self.env.get("TPU_SLICE_ID") or self.env.get("MEGASCALE_SLICE_ID")
        if not topo_s or not slice_id:
            return None
        topology = (MeshShape.parse(topo_s) if "x" in topo_s
                    else parse_bounds(topo_s))
        host_bounds = parse_bounds(
            self.env.get("TPU_CHIPS_PER_HOST_BOUNDS", "2,2,1"))
        worker_id = int(self.env.get("TPU_WORKER_ID", "0"))
        hostnames = [h for h in
                     self.env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
        num_workers = len(hostnames) or max(
            topology.num_chips // host_bounds.num_chips, 1)
        coordinator = hostnames[0] if hostnames else ""
        return SliceMembership(
            slice_id=slice_id, topology=topology, worker_id=worker_id,
            num_workers=num_workers, host_bounds=host_bounds,
            coordinator_address=coordinator)

    def _nvidia_cards(self) -> list[tuple[int, str, GenerationSpec, str, int]]:
        """(minor, uuid, generation, bus id, numa node) of every NVIDIA
        card, by the procfs path or, where PCI sysfs shows none, the
        driver path (see the module docstring)."""
        by_product = {}
        for gen in GENERATIONS.values():
            by_product.setdefault(gen.product_name, gen)
        pci = _nvidia_pci(self.root)
        cards = []
        if pci:
            for d in pci:
                got = _procfs_minor(self.root, d.name)
                if got is None:
                    continue
                minor, info = got
                gen = by_product.get(nvidia_product_name(
                    info.get("Model", "")))
                if gen is None:
                    continue
                uuid = info.get("GPU UUID", "")
                if not _GPU_UUID.fullmatch(uuid):
                    digest = hashlib.sha256(
                        f"{self.hostname}/{d.name}/{minor}".encode()
                    ).hexdigest()[:16]
                    uuid = f"GPU-{gen.name}-{digest}"
                numa = int(_read(d / "numa_node") or -1)
                cards.append((minor, uuid, gen, d.name, numa))
        elif (self.root / "dev/nvidiactl").exists():
            lib = find_libcuda(self.root)
            if lib is None:
                return []
            libcuda = self.root / lib
            for minor, uuid, bus, name in driver_cards(
                    libcuda, libcuda.parent / NVML_NAME):
                gen = by_product.get(nvidia_product_name(name))
                if gen is not None:
                    cards.append((minor, uuid, gen, bus, -1))
        return sorted(cards, key=lambda c: c[0])

    def _libtpu_path(self, nvidia: bool = False) -> str:
        explicit = self.env.get("LIBTPU_INIT_PATH") or self.env.get("TPU_LIBRARY_PATH")
        if explicit:
            return explicit
        if nvidia:
            lib = find_libcuda(self.root)
            return "/" + lib if lib else ""
        for rel in LIBTPU_SEARCH_PATHS:
            if (self.root / rel).is_file():
                return "/" + rel
        return ""

    # -- health ------------------------------------------------------------

    def health(self, expected=None) -> dict[int, str]:
        return sysfs_health(self.root, expected)

    # -- main entry point --------------------------------------------------

    def enumerate(self) -> HostTopology:
        slice_info = self._slice_membership()
        host_bounds = (slice_info.host_bounds if slice_info
                       else parse_bounds(
                           self.env.get("TPU_CHIPS_PER_HOST_BOUNDS", "2,2,1")))
        origin = (host_origin(slice_info.worker_id, host_bounds,
                              slice_info.topology)
                  if slice_info else ICICoord(0, 0, 0))

        chips: list[ChipInfo] = []
        for accel_dir in self._accel_dirs():
            index = int(accel_dir.name.removeprefix("accel"))
            device_dir = accel_dir / "device"
            gen = self._generation_for(device_dir)
            if gen is None:
                continue
            pci = os.path.basename(os.path.realpath(device_dir))
            numa = int(_read(device_dir / "numa_node") or -1)
            serial = _read(device_dir / "serial_number")
            if serial:
                uuid = f"TPU-{gen.name}-{serial}"
            else:
                digest = hashlib.sha256(
                    f"{self.hostname}/{pci}/{index}".encode()).hexdigest()[:16]
                uuid = f"TPU-{gen.name}-{digest}"
            lx = index % host_bounds.x
            ly = (index // host_bounds.x) % host_bounds.y
            lz = index // (host_bounds.x * host_bounds.y)
            coord = ICICoord(origin.x + lx, origin.y + ly, origin.z + lz)
            dev = f"/dev/accel{index}"
            dev_paths = [dev]
            # vfio passthrough nodes, when present, ride along.
            vfio = self.root / f"dev/vfio/{index}"
            if vfio.exists():
                dev_paths.append(f"/dev/vfio/{index}")
            chips.append(ChipInfo(
                index=index, uuid=uuid, generation=gen, coord=coord,
                dev_paths=tuple(dev_paths), pci_address=pci, numa_node=numa))

        cards = self._nvidia_cards()
        if chips and cards:
            raise ValueError(
                f"host shows accel-class chips {[c.index for c in chips]} "
                f"and NVIDIA cards {[c[0] for c in cards]}: one host "
                f"serves one kind")
        if cards:
            chips = [ChipInfo(index=minor, uuid=uuid, generation=gen,
                              coord=ICICoord(k, 0, 0),
                              dev_paths=(f"/dev/nvidia{minor}",),
                              pci_address=bus, numa_node=numa)
                     for k, (minor, uuid, gen, bus, numa)
                     in enumerate(cards)]
            slice_info = None
        return HostTopology(
            hostname=self.hostname, chips=tuple(chips),
            libtpu_path=self._libtpu_path(bool(cards)), slice=slice_info)
