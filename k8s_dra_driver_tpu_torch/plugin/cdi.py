"""CDI (Container Device Interface) spec generation, by host kind.

The port's copy of ``k8s_dra_driver_tpu/plugin/cdi.py``, the analog of
the reference's CDIHandler (reference
cmd/nvidia-dra-plugin/cdi.go:50-298).  A TPU host gets the reference's
TPU container contract unchanged, byte for byte:

- device nodes ``/dev/accel<i>`` (+ ``/dev/vfio/<i>`` when present);
- a read-only bind mount of the host's ``libtpu.so`` at
  ``/usr/lib/libtpu.so``;
- the libtpu env contract (``TPU_VISIBLE_CHIPS``,
  ``TPU_VISIBLE_CORES``, ``TPU_CHIPS_PER_HOST_BOUNDS`` ...), with
  ``TPU_SKIP_MDS_QUERY=true`` in the standard spec's common edits so
  libtpu never falls back to host-level metadata discovery.

An NVIDIA host (its cards' generation is ``"h100"``; discovery refuses
a host that shows both kinds) gets the NVIDIA container contract in
its place:

- device nodes ``/dev/nvidia<minor>`` per card (the chip's
  ``dev_paths``), and in the common edits ``/dev/nvidiactl``,
  ``/dev/nvidia-uvm`` and ``/dev/nvidia-uvm-tools``, each where it
  exists under the driver root;
- read-only bind mounts of the host's ``libcuda.so.1`` (discovery's
  ``libtpu_path`` on such a host) and of ``libnvidia-ml.so.1`` beside
  it where it exists, at ``CONTAINER_LIBCUDA_PATH`` and
  ``CONTAINER_NVML_PATH``;
- ``NVIDIA_VISIBLE_DEVICES=void`` in the common edits (reference
  cdi.go:175-180: no runtime hook adds cards behind the spec's back),
  and ``CUDA_VISIBLE_DEVICES=<the claimed cards' GPU UUIDs, in minor
  order>`` in the claim spec.  An H100 has one core, the whole card,
  and no host-bounds contract, so no core or bounds variable is
  emitted: a core claim sees the same ``CUDA_VISIBLE_DEVICES`` as its
  card.

Everything else keeps the reference's names: the driver name and CDI
kinds, and the time-slicing and coordinator variables and mounts.

Two spec files per node, exactly like the reference: one *standard*
spec enumerating every allocatable device (written once at startup,
cdi.go:158-227 analog), and one transient *per-claim* spec carrying
claim-scoped edits: topology env, sharing env, coordinator mounts
(cdi.go:229-279 analog).  Workload visibility comes from injecting only
the claimed device nodes.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from ..devicemodel import AllocatableDevice, KIND_CORE, PreparedClaim
from ..discovery import HostTopology

CDI_VERSION = "0.6.0"
CDI_VENDOR = "tpu.google.com"
CDI_DEVICE_KIND = f"{CDI_VENDOR}/chip"
CDI_CLAIM_KIND = f"{CDI_VENDOR}/claim"

STANDARD_SPEC_FILENAME = "tpu.google.com-chip.json"

# Container-side libtpu location; host side comes from discovery.
CONTAINER_LIBTPU_PATH = "/usr/lib/libtpu.so"

#: generations served by the NVIDIA container contract
NVIDIA_GENERATIONS = frozenset({"h100"})
#: control nodes every CUDA process opens, injected where the host has them
NVIDIA_COMMON_NODES = ("/dev/nvidiactl", "/dev/nvidia-uvm",
                       "/dev/nvidia-uvm-tools")
NVML_NAME = "libnvidia-ml.so.1"
# Container-side driver libraries: the directory the CUDA images put
# on their loader path (LD_LIBRARY_PATH=/usr/local/nvidia/lib64).
CONTAINER_LIBCUDA_PATH = "/usr/local/nvidia/lib64/libcuda.so.1"
CONTAINER_NVML_PATH = f"/usr/local/nvidia/lib64/{NVML_NAME}"


def is_nvidia_host(topology: HostTopology) -> bool:
    """True when the host's chips are NVIDIA cards (discovery never
    mixes the two kinds on one host)."""
    return any(c.generation.name in NVIDIA_GENERATIONS
               for c in topology.chips)


class ContainerEdits:
    """Accumulator for CDI containerEdits."""

    def __init__(self):
        self.env: dict[str, str] = {}
        self.device_nodes: list[str] = []
        self.mounts: list[tuple[str, str, tuple[str, ...]]] = []

    def merge(self, other: "ContainerEdits") -> "ContainerEdits":
        self.env.update(other.env)
        self.device_nodes.extend(other.device_nodes)
        self.mounts.extend(other.mounts)
        return self

    def to_json(self) -> dict:
        out: dict = {}
        if self.env:
            out["env"] = [f"{k}={v}" for k, v in sorted(self.env.items())]
        if self.device_nodes:
            out["deviceNodes"] = [{"path": p} for p in self.device_nodes]
        if self.mounts:
            out["mounts"] = [
                {"hostPath": h, "containerPath": c, "options": list(opts)}
                for h, c, opts in self.mounts]
        return out


class CDIHandler:
    def __init__(self, cdi_root: str, driver_root: str = "/",
                 host_driver_root: str | None = None):
        """``driver_root``: where this process sees the driver's files;
        ``host_driver_root``: where the node's container runtime sees
        them, which a mount's ``hostPath`` names (the driver root when
        not given, as the JAX package writes it)."""
        self.cdi_root = Path(cdi_root)
        self.driver_root = driver_root.rstrip("/") or "/"
        self.host_driver_root = (self.driver_root if host_driver_root is None
                                 else host_driver_root.rstrip("/") or "/")
        self.cdi_root.mkdir(parents=True, exist_ok=True)

    # -- qualified names (cdi.go:281-298 analog) -------------------------

    @staticmethod
    def standard_device_id(device_name: str) -> str:
        return f"{CDI_DEVICE_KIND}={device_name}"

    @staticmethod
    def claim_device_id(claim_uid: str) -> str:
        return f"{CDI_CLAIM_KIND}={claim_uid}"

    # -- device-level edits ----------------------------------------------

    def _device_edits(self, dev: AllocatableDevice) -> ContainerEdits:
        edits = ContainerEdits()
        for chip in dev.chips:
            for path in chip.dev_paths:
                edits.device_nodes.append(path)
        # Core visibility env (TPU_VISIBLE_CORES) is claim-level only
        # (claim_topology_edits): env merge across CDI devices is
        # last-wins, so per-device values would drop cores whenever a
        # claim holds more than one.
        return edits

    def _host_path(self, path: str) -> str:
        """Transform a host path for when the plugin runs containerized
        with the host filesystem at driver_root (root-transform analog,
        cdi.go:116-141 / root.go)."""
        if self.driver_root == "/":
            return path
        return self.driver_root + path

    def _node_path(self, path: str) -> str:
        """A host path as the node's container runtime resolves it: a
        mount's ``hostPath``."""
        if self.host_driver_root == "/":
            return path
        return self.host_driver_root + path

    # -- standard spec ----------------------------------------------------

    def create_standard_spec(self, devices: dict[str, AllocatableDevice],
                             libtpu_path: str = "",
                             nvidia: bool = False) -> Path:
        """``libtpu_path``: the host's libtpu, or on an NVIDIA host
        (``nvidia``) its ``libcuda.so.1``."""
        common = (self._nvidia_common_edits(libtpu_path) if nvidia
                  else self._tpu_common_edits(libtpu_path))
        spec = {
            "cdiVersion": CDI_VERSION,
            "kind": CDI_DEVICE_KIND,
            "devices": [
                {"name": name,
                 "containerEdits": self._device_edits(dev).to_json()}
                for name, dev in sorted(devices.items())
            ],
            "containerEdits": common.to_json(),
        }
        return self._write(STANDARD_SPEC_FILENAME, spec)

    def _tpu_common_edits(self, libtpu_path: str) -> ContainerEdits:
        common = ContainerEdits()
        common.env["TPU_SKIP_MDS_QUERY"] = "true"
        if libtpu_path:
            common.mounts.append((self._node_path(libtpu_path),
                                  CONTAINER_LIBTPU_PATH, ("ro", "bind")))
        return common

    def _nvidia_common_edits(self, libcuda_path: str) -> ContainerEdits:
        common = ContainerEdits()
        common.env["NVIDIA_VISIBLE_DEVICES"] = "void"
        common.device_nodes.extend(
            p for p in NVIDIA_COMMON_NODES
            if Path(self._host_path(p)).exists())
        if libcuda_path:
            common.mounts.append((self._node_path(libcuda_path),
                                  CONTAINER_LIBCUDA_PATH, ("ro", "bind")))
            nvml = str(Path(libcuda_path).parent / NVML_NAME)
            if Path(self._host_path(nvml)).exists():
                common.mounts.append((self._node_path(nvml),
                                      CONTAINER_NVML_PATH, ("ro", "bind")))
        return common

    # -- per-claim spec ----------------------------------------------------

    def create_claim_spec(self, claim_uid: str,
                          edits: ContainerEdits) -> Path:
        spec = {
            "cdiVersion": CDI_VERSION,
            "kind": CDI_CLAIM_KIND,
            "devices": [
                {"name": claim_uid, "containerEdits": edits.to_json()},
            ],
            "containerEdits": {},
        }
        return self._write(self._claim_filename(claim_uid), spec)

    def delete_claim_spec(self, claim_uid: str) -> None:
        path = self.cdi_root / self._claim_filename(claim_uid)
        try:
            path.unlink()
        except FileNotFoundError:
            pass

    @staticmethod
    def _claim_filename(claim_uid: str) -> str:
        return f"tpu.google.com-claim_{claim_uid}.json"

    def _write(self, filename: str, spec: dict) -> Path:
        """Atomic write (tmp + rename) so the container runtime never
        reads a torn spec; every spec is validated against the
        vendored CDI v0.x schema first (cdi_schema.py) — the
        runtime-boundary proof available without a container runtime,
        and the same fail-at-generation discipline the reference gets
        from building specs through the validated CDI library types
        (cdi.go:50-298)."""
        from .cdi_schema import validate_spec
        validate_spec(spec)
        path = self.cdi_root / filename
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(spec, indent=2, sort_keys=True) + "\n")
        os.replace(tmp, path)
        return path

    def read_spec(self, filename: str) -> dict:
        return json.loads((self.cdi_root / filename).read_text())


def claim_topology_edits(prepared: PreparedClaim,
                         host_bounds: str = "",
                         slice_env: dict[str, str] | None = None,
                         card_uuids: dict[int, str] | None = None
                         ) -> ContainerEdits:
    """Claim-level env describing exactly the chips this claim sees.

    On a TPU host ``TPU_VISIBLE_CHIPS`` carries host chip indices so
    libtpu binds only the injected devices; bounds/topology env mirror
    what GKE's TPU device plugin sets so a workload runs unmodified.
    On an NVIDIA host (``card_uuids``: each card's GPU UUID by its
    minor) ``CUDA_VISIBLE_DEVICES`` names the claimed cards by UUID in
    minor order, and no core or bounds variable is set.
    """
    edits = ContainerEdits()
    indices = sorted({i for d in prepared.devices for i in d.chip_indices})
    if card_uuids is not None:
        edits.env["CUDA_VISIBLE_DEVICES"] = ",".join(
            card_uuids[i] for i in indices)
    else:
        edits.env["TPU_VISIBLE_CHIPS"] = ",".join(str(i) for i in indices)
        # Aggregate core visibility at claim level: per-device env would
        # last-write-wins when a claim holds several cores (tpu-test4's
        # matchAttribute-paired cores), so the claim spec carries the
        # union.
        cores = sorted({(d.chip_indices[0], d.core_index)
                        for d in prepared.devices
                        if d.kind == KIND_CORE and d.core_index >= 0})
        if cores:
            edits.env["TPU_VISIBLE_CORES"] = ",".join(
                f"{c}:{j}" for c, j in cores)
        if host_bounds:
            edits.env["TPU_CHIPS_PER_HOST_BOUNDS"] = host_bounds
    for k, v in (slice_env or {}).items():
        edits.env[k] = v
    return edits
