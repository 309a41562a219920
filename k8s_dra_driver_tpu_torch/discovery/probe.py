"""Read-only probe of what a host shows of its NVIDIA cards: the
sources the NVIDIA path of ``sysfs.py`` reads, and what each holds.

    python3 -m k8s_dra_driver_tpu_torch.discovery.probe [host_root]

prints one JSON object: the NVIDIA display-class PCI devices under
``/sys/bus/pci/devices``, the driver's ``/proc/driver/nvidia/gpus``
entries (``null`` where the directory is absent), each ``/dev/nvidia*``
node and whether it opens, the ``libcuda.so.1`` found and whether NVML
sits beside it, the cards of ``driver_cards`` (minor, bus id, name),
what NVML says of each of its cards beside the CUDA driver (whether its
UUID is CUDA's, the return code of its PCI query, the driver version),
and the tools the driver's layers need on that host (``g++`` for the
shims, ``grpcio`` and ``protobuf`` for the kubelet plugin).  UUIDs are
compared, not printed.  Nothing is written and no setting is changed;
opening a node is what the CUDA driver does.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.metadata
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from .sysfs import NVML_NAME, _nvidia_pci, driver_cards, find_libcuda


def _opens(path: Path) -> str:
    try:
        os.close(os.open(path, os.O_RDWR))
    except OSError as e:
        return e.strerror or str(e)
    return "opens"


def _nvml_facts(nvml: Path, cuda_uuids: set[str]) -> dict:
    nv = ctypes.CDLL(str(nvml))
    nv.nvmlDeviceGetHandleByIndex_v2.argtypes = [
        ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
    out: dict = {"init": nv.nvmlInit_v2()}
    try:
        buf = ctypes.create_string_buffer(96)
        get = getattr(nv, "nvmlSystemGetDriverVersion", None)
        out["driver_version"] = (buf.value.decode() if get is not None
                                 and get(buf, 96) == 0 else None)
        count = ctypes.c_uint()
        nv.nvmlDeviceGetCount_v2(ctypes.byref(count))
        cards = []
        for index in range(count.value):
            handle = ctypes.c_void_p()
            nv.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(handle))
            card: dict = {"index": index}
            get_uuid = getattr(nv, "nvmlDeviceGetUUID", None)
            if get_uuid is not None:
                get_uuid.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint]
                buf = ctypes.create_string_buffer(96)
                card["uuid_rc"] = get_uuid(handle, buf, 96)
                card["uuid_is_cudas"] = buf.value.decode() in cuda_uuids
            get_pci = getattr(nv, "nvmlDeviceGetPciInfo_v3", None)
            if get_pci is not None:
                get_pci.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                card["pci_info_rc"] = get_pci(
                    handle, ctypes.create_string_buffer(128))
            cards.append(card)
        out["cards"] = cards
    finally:
        nv.nvmlShutdown()
    return out


#: modules the plugin imports beside grpc and protobuf (the CDI schema
#: check, the coordinator template, kubeconfigs), and the reference's
#: metrics library the port's registry stands in for: module ->
#: distribution
_PACKAGES = {"jsonschema": "jsonschema", "yaml": "PyYAML",
             "prometheus_client": "prometheus_client"}


def tools() -> dict:
    """``g++``'s version line and the versions of the Python modules
    the plugin needs, and of ``prometheus_client`` (None where absent)."""
    gxx = shutil.which("g++")
    out = {"g++": subprocess.run(
        [gxx, "--version"], capture_output=True, text=True,
        timeout=30).stdout.splitlines()[0] if gxx else None}
    for name in ("grpc", "google.protobuf"):
        try:
            out[name] = importlib.import_module(name).__version__
        except ImportError:
            out[name] = None
    for name, dist in _PACKAGES.items():
        try:
            importlib.import_module(name)
            out[name] = importlib.metadata.version(dist)
        except ImportError:
            out[name] = None
    return out


def probe(host_root: str = "/") -> dict:
    root = Path(host_root)
    gpus = root / "proc/driver/nvidia/gpus"
    dev = root / "dev"
    out = {
        "pci_nvidia": [d.name for d in _nvidia_pci(root)],
        "procfs_gpus": sorted(p.name for p in gpus.iterdir())
        if gpus.is_dir() else None,
        "dev_nodes": {p.name: _opens(p) for p in sorted(
            dev.glob("nvidia*"))} if dev.is_dir() else {},
    }
    lib = find_libcuda(root)
    out["libcuda"] = "/" + lib if lib else None
    if lib is None:
        return out
    nvml = (root / lib).parent / NVML_NAME
    out["nvml_beside_libcuda"] = nvml.is_file()
    if nvml.is_file():
        cards = driver_cards(root / lib, nvml)
        out["cards"] = [dict(minor=m, bus=bus, name=name)
                        for m, _, bus, name in cards]
        out["nvml"] = _nvml_facts(nvml, {uuid for _, uuid, _, _ in cards})
    return out


if __name__ == "__main__":
    print(json.dumps(dict(probe(*sys.argv[1:2]), tools=tools())),
          flush=True)
