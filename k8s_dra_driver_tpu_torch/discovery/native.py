"""Native discovery backend: ctypes wrapper over the port's
``native/tpudiscovery.cc``.

The port's copy of ``k8s_dra_driver_tpu/discovery/native.py`` over its
own shim: a sysfs/env/procfs parser, which on an NVIDIA host without
PCI sysfs opens the driver's libraries itself, compiled to
``build/native/libtpudiscovery.so`` (``utils/nativebuild.py``;
``TPU_DISCOVERY_LIB`` names a prebuilt one).  It must produce
byte-identical facts to the pure-Python ``SysfsBackend``, TPU trees and
NVIDIA trees alike.  The generation table is passed in from
``topology.GENERATIONS`` so Python stays the single source of truth.
A host showing both kinds of device raises ``ValueError`` with
``SysfsBackend``'s message.
"""

from __future__ import annotations

import ctypes
import json
import os
from pathlib import Path

from ..utils import nativebuild
from .topology import GENERATIONS, ICICoord, MeshShape
from .types import ChipInfo, DiscoveryBackend, HostTopology, SliceMembership

DEFAULT_LIB = nativebuild.BUILD_DIR / "libtpudiscovery.so"


class NativeUnavailableError(RuntimeError):
    pass


def generations_spec() -> str:
    """Serialize GENERATIONS for the shim (one `name|product|cores|hbm|
    pci,...` line per generation)."""
    lines = []
    for g in GENERATIONS.values():
        lines.append("|".join([
            g.name, g.product_name, str(g.cores_per_chip),
            str(g.hbm_bytes_per_chip), ",".join(g.pci_ids)]))
    return "\n".join(lines)


def ensure_built(source: Path | None = None,
                 lib_path: Path | None = None) -> Path:
    """Return a usable shared library, compiling it if needed."""
    return nativebuild.ensure_built(
        source or (nativebuild.NATIVE_DIR / "tpudiscovery.cc"),
        lib_path or DEFAULT_LIB,
        "TPU_DISCOVERY_LIB", NativeUnavailableError)


class NativeBackend(DiscoveryBackend):
    def __init__(self, host_root: str = "/",
                 env: dict[str, str] | None = None,
                 hostname: str | None = None,
                 lib_path: str | Path | None = None):
        self.root = str(host_root)
        if env is None:
            from .sysfs import load_env_overlay
            env = dict(os.environ)
            env.update(load_env_overlay(self.root, env))
        self.env = dict(env)
        if hostname:
            self.env["HOSTNAME"] = hostname
        path = Path(lib_path) if lib_path else ensure_built()
        try:
            self._lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeUnavailableError(f"cannot load {path}: {e}") from e
        self._lib.tpu_discover.restype = ctypes.c_int
        self._lib.tpu_discover.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_size_t]

    def _call(self) -> dict:
        gens = generations_spec().encode()
        env = "\n".join(f"{k}={v}" for k, v in self.env.items()).encode()
        size = 1 << 16
        for _ in range(2):
            buf = ctypes.create_string_buffer(size)
            rc = self._lib.tpu_discover(self.root.encode(), gens, env,
                                        buf, size)
            if rc == -2:
                raise ValueError(buf.value.decode(errors="replace"))
            if rc < 0:
                raise RuntimeError(
                    f"tpu_discover: {buf.value.decode(errors='replace')}")
            if rc <= size:
                return json.loads(buf.value.decode())
            size = rc           # buffer too small: retry at needed size
        raise RuntimeError("tpu_discover: buffer negotiation failed")

    def health(self, expected=None) -> dict[int, str]:
        """Health is a per-poll sysfs observation regardless of which
        backend enumerated the chips — reuse the shared probe so
        ``--discovery native`` nodes get real monitoring instead of the
        interface's always-healthy default."""
        from .sysfs import sysfs_health
        return sysfs_health(self.root, expected)

    def enumerate(self) -> HostTopology:
        data = self._call()
        slice_info = None
        if data["slice"] is not None:
            s = data["slice"]
            slice_info = SliceMembership(
                slice_id=s["slice_id"],
                topology=MeshShape(*s["topology"]),
                worker_id=s["worker_id"],
                num_workers=s["num_workers"],
                host_bounds=MeshShape(*s["host_bounds"]),
                coordinator_address=s["coordinator_address"])
        chips = tuple(
            ChipInfo(index=c["index"], uuid=c["uuid"],
                     generation=GENERATIONS[c["generation"]],
                     coord=ICICoord(*c["coord"]),
                     dev_paths=tuple(c["dev_paths"]),
                     pci_address=c["pci_address"],
                     numa_node=c["numa_node"])
            for c in data["chips"])
        return HostTopology(hostname=data["hostname"], chips=chips,
                            libtpu_path=data["libtpu_path"],
                            slice=slice_info)
