"""Sharing-strategy application: time-slicing + coordinator daemons.

The port's copy of ``k8s_dra_driver_tpu/plugin/sharing.py``, with the
same policy files, timeshare directory, environment variables, mounts
and coordinator Deployment template on both host kinds.  The analog of the reference's TimeSlicingManager / MpsManager
(reference cmd/nvidia-dra-plugin/sharing.go:58-403), with TPU-native
mechanisms:

- Time-slicing.  There is no ``nvidia-smi compute-policy`` analog on
  TPU; the preemption quantum is a *node-local scheduling policy* the
  runtime coordinator (and libtpu via env) honours.  The manager writes
  one policy file per chip under the plugin dir and the per-claim CDI
  spec carries ``TPU_RUNTIME_PREEMPTION_MS``; reset restores the default
  the way unprepare resets time-slicing on full GPUs
  (device_state.go:358-362).
- Coordinated sharing.  A per-claim coordinator Deployment (the
  MPS-control-daemon lifecycle, sharing.go:185-366): render template →
  create via the cluster client → poll readiness with the same backoff
  envelope → emit CDI edits (coordination-dir mount + env) → teardown.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import string
import time
from pathlib import Path

import yaml

from ..api.config.v1alpha1 import (CoordinatedSettings, TimeSlicingSettings)
from ..api.resource import ObjectMeta
from ..cluster import ClusterClient, ConflictError, Deployment, NotFoundError
from ..coordclient.client import READY_FILE
from ..devicemodel import AllocatableDevice, KIND_CHIP, KIND_SLICE
from ..utils.backoff import Backoff
from ..utils.files import wait_for_file
from .cdi import ContainerEdits

TEMPLATE_PATH = Path(__file__).parent / "templates/coordinator-daemon.yaml"

# Parsed-once template tree: reading + yaml-parsing the manifest was
# 6.4 ms of EVERY coordinated prepare (the largest single slice of the
# oop coordinated-shared p50 after the readiness polls were fixed —
# tools/oop_prepare_latency.json).  Every placeholder sits inside a
# string scalar, so substitution can walk the parsed tree per claim
# while the parse happens once per process.
_TEMPLATE_TREE: dict | None = None


def _render_manifest(mapping: dict[str, str]) -> dict:
    global _TEMPLATE_TREE
    if _TEMPLATE_TREE is None:
        _TEMPLATE_TREE = yaml.safe_load(TEMPLATE_PATH.read_text())

    def sub(node):
        if isinstance(node, str):
            return string.Template(node).substitute(mapping)
        if isinstance(node, dict):
            return {k: sub(v) for k, v in node.items()}
        if isinstance(node, list):
            return [sub(x) for x in node]
        return node
    return sub(_TEMPLATE_TREE)

# The driver image carries all the entrypoints (plugin, controller,
# tpu-coordinatord, tpu-coordclient — deployments/container/Dockerfile),
# so coordinator pods run the same image the DaemonSet does.  There is
# deliberately NO code-level default image: the chart passes the
# release image/tag through COORDINATOR_IMAGE (templates/
# kubeletplugin.yaml), and without one configured a Coordinated claim
# fails prepare in-band (CoordinatorDaemon.start); a hardcoded
# fallback here would be a nonexistent registry path that only fails
# at pod-schedule time.
DEFAULT_COORDINATOR_IMAGE = ""


class SharingError(RuntimeError):
    pass


class TimeSlicingManager:
    """Applies preemption-quantum policy to whole chips/slices.

    Rejects core partitions the way the reference rejects MIG devices
    (sharing.go:103-110); resetting compute mode first has no TPU analog,
    so set/reset is the policy file + env + the node-level *timeshare
    directory*: every time-sliced claim gets it bind-mounted, and the
    ``tpu-coordclient`` gate flock()s ``chip<i>.lock`` inside it for one
    quantum at a time — kernel-enforced mutual exclusion between claims
    sharing a chip, where the reference flips a GPU scheduler knob
    (nvlib.go:521-539).
    """

    #: container-side mount point of the node timeshare dir
    CONTAINER_TIMESHARE_DIR = "/var/run/tpu-timeshare"

    def __init__(self, plugin_root: str):
        self.policy_dir = Path(plugin_root) / "policy"
        self.policy_dir.mkdir(parents=True, exist_ok=True)
        self.timeshare_dir = Path(plugin_root) / "timeshare"
        self.timeshare_dir.mkdir(parents=True, exist_ok=True)

    def set_time_slice(self, devices: list[AllocatableDevice],
                       settings: TimeSlicingSettings) -> list[int]:
        chips: list[int] = []
        for dev in devices:
            if dev.kind not in (KIND_CHIP, KIND_SLICE):
                raise SharingError(
                    f"time-slicing is not supported on {dev.kind} devices")
            chips.extend(c.index for c in dev.chips)
        for idx in chips:
            self._write_policy(idx, settings.interval_ms)
        return chips

    def reset(self, chip_indices: list[int]) -> None:
        for idx in chip_indices:
            self._write_policy(idx, 0)

    def current_policy(self, chip_index: int) -> int:
        path = self.policy_dir / f"chip{chip_index}.json"
        if not path.exists():
            return 0
        return json.loads(path.read_text()).get("preemptionMs", 0)

    def _write_policy(self, chip_index: int, preemption_ms: int) -> None:
        path = self.policy_dir / f"chip{chip_index}.json"
        if preemption_ms == 0:
            path.unlink(missing_ok=True)
        else:
            path.write_text(json.dumps({"preemptionMs": preemption_ms}))


class CoordinatorDaemon:
    """Lifecycle of one per-claim coordinator Deployment
    (MpsControlDaemon analog, sharing.go:124-403)."""

    def __init__(self, manager: "CoordinatorManager", claim_uid: str,
                 devices: list[AllocatableDevice],
                 settings: CoordinatedSettings,
                 preemption_ms: int = 0):
        self.manager = manager
        self.claim_uid = claim_uid
        self.devices = devices
        self.settings = settings
        self.preemption_ms = preemption_ms
        uuids = sorted(u for d in devices for u in d.uuids)
        digest = hashlib.sha256(":".join(uuids).encode()).hexdigest()[:12]
        # claimUID+uuid-hash identity (GetMpsControlDaemonID analog,
        # sharing.go:151-155).
        self.id = f"coord-{claim_uid[:13]}-{digest}"
        self.name = f"tpu-coordinator-{self.id}"

    @property
    def coordination_dir(self) -> Path:
        return self.manager.coordination_root / self.id

    def start(self) -> None:
        if not self.manager.image:
            # Fail at prepare time with an in-band claim error instead
            # of scheduling a pod that can never pull.
            raise SharingError(
                "no coordinator image configured: set --coordinator-image "
                "/ env COORDINATOR_IMAGE (the chart wires this from "
                ".Values.image)")
        cdir = self.coordination_dir
        (cdir / "log").mkdir(parents=True, exist_ok=True)
        (cdir / "ctl").mkdir(parents=True, exist_ok=True)
        uuids = [u for d in self.devices for u in d.uuids]
        limits = self.settings.resolved_hbm_limits(uuids)
        chips = sorted({c.index for d in self.devices for c in d.chips})
        manifest = _render_manifest(dict(
            name=self.name,
            namespace=self.manager.namespace,
            claim_uid=self.claim_uid,
            id=self.id,
            node_name=self.manager.node_name,
            image=self.manager.image,
            duty_cycle_percent=str(self.settings.duty_cycle_percent),
            preemption_ms=str(self.preemption_ms),
            hbm_limits=",".join(f"{u}={b}" for u, b in sorted(limits.items())),
            visible_chips=",".join(str(c) for c in chips),
            coordination_dir=str(cdir),
            policy_dir=str(self.manager.policy_dir),
            enforce="true" if self.settings.enforce else "false",
            hbm_action=self.settings.violation_action,
        ))
        deployment = Deployment(
            metadata=ObjectMeta(
                name=self.name, namespace=self.manager.namespace,
                labels=manifest["metadata"]["labels"]),
            spec=manifest["spec"])
        try:
            self.manager.client.create(deployment)
        except ConflictError:
            # Already exists (restart-idempotency): adopt it.
            self.manager.client.get(
                "Deployment", self.manager.namespace, self.name)
        except Exception as e:
            # RBAC denial, bad manifest, API down… are NOT
            # already-exists; masking them as adoption would surface a
            # 403 as a confusing NotFoundError.
            raise SharingError(
                f"creating coordinator deployment {self.name}: {e}") from e
        # Policy snapshot for workloads/coordinator, mirroring how MPS
        # passes limits through the daemon's control pipe.
        (cdir / "policy.json").write_text(json.dumps({
            "dutyCyclePercent": self.settings.duty_cycle_percent,
            "hbmLimits": limits,
            "preemptionMs": self.preemption_ms,
            "chips": chips,
        }, sort_keys=True))

    def assert_ready(self, sleep=time.sleep) -> None:
        """Wait for the coordinator to serve (AssertReady analog,
        sharing.go:289-344), cheapest signal first:

        1. **Readiness-file watch.**  The daemon's FIRST act is
           atomically publishing ``<coordination-dir>/ready`` — the
           very file its Deployment readiness probe cats — and that
           directory lives on this node's filesystem (the plugin
           created it; the daemon pod bind-mounts it).  An adaptive
           sub-ms watch (utils/files.py) sees it the moment it lands,
           skipping the REST round-trips and poll sleeps (the poll
           interval, not the work, set the coordinated prepare's
           floor).
        2. **Deployment-status backoff poll** as the fallback, which
           still checks the file each round (apiserver status lag must
           not out-wait a daemon that is already serving).  On timeout
           the error carries the deployment + pod status so a
           crash-looping or unschedulable coordinator is diagnosable
           from the claim's in-band error.
        """
        ready_file = self.coordination_dir / READY_FILE
        if wait_for_file(ready_file, budget_s=1.0, sleep=sleep):
            return

        def ready() -> bool:
            if ready_file.exists():
                return True
            try:
                dep = self.manager.client.get(
                    "Deployment", self.manager.namespace, self.name)
            except NotFoundError:
                return False
            return bool(dep.ready)
        if not self.manager.backoff.poll(ready, sleep=sleep):
            raise SharingError(
                f"coordinator daemon {self.name} never became ready"
                f"{self._diagnose()}")

    def _diagnose(self) -> str:
        """Best-effort status of the deployment and its pods for the
        readiness-timeout error message."""
        try:
            dep = self.manager.client.get(
                "Deployment", self.manager.namespace, self.name)
            note = (f": deployment {dep.ready_replicas}/{dep.replicas} "
                    f"ready")
        except NotFoundError:
            return ": deployment not found (deleted underneath us?)"
        except Exception:
            return ""
        try:
            pods = self.manager.client.list(
                "Pod", self.manager.namespace,
                {"tpu.google.com/coordinator-id": self.id})
        except Exception:
            return note
        for pod in pods:
            detail = pod.phase
            statuses = (pod.raw.get("status", {}) or {}) \
                .get("containerStatuses", [])
            for cs in statuses:
                waiting = (cs.get("state", {}) or {}).get("waiting")
                if waiting and waiting.get("reason"):
                    detail += f"/{waiting['reason']}"
                    if waiting.get("message"):
                        detail += f" ({waiting['message'][:120]})"
                restarts = cs.get("restartCount", 0)
                if restarts:
                    detail += f", {restarts} restarts"
            note += f"; pod {pod.metadata.name}: {detail}"
        return note

    def cdi_edits(self) -> ContainerEdits:
        """Env + mounts workloads need to rendezvous with the coordinator
        (GetCDIContainerEdits analog, sharing.go:346-366)."""
        edits = ContainerEdits()
        edits.env["TPU_COORDINATOR_DIR"] = "/coordination"
        edits.env["TPU_COORDINATOR_DUTY_CYCLE_PCT"] = str(
            self.settings.duty_cycle_percent)
        if self.preemption_ms:
            edits.env["TPU_RUNTIME_PREEMPTION_MS"] = str(self.preemption_ms)
        edits.mounts.append((str(self.coordination_dir), "/coordination",
                             ("rw", "bind")))
        return edits

    def stop(self) -> None:
        try:
            self.manager.client.delete(
                "Deployment", self.manager.namespace, self.name)
        except NotFoundError:
            pass
        shutil.rmtree(self.coordination_dir, ignore_errors=True)


class CoordinatorManager:
    def __init__(self, client: ClusterClient, plugin_root: str,
                 node_name: str, namespace: str = "tpu-dra-driver",
                 image: str = DEFAULT_COORDINATOR_IMAGE,
                 backoff: Backoff | None = None):
        self.client = client
        self.coordination_root = Path(plugin_root) / "coordinator"
        self.coordination_root.mkdir(parents=True, exist_ok=True)
        # Same dir TimeSlicingManager writes: rendered daemons mount it
        # read-only and consume the per-chip policy files.
        self.policy_dir = Path(plugin_root) / "policy"
        self.node_name = node_name
        self.namespace = namespace
        self.image = image
        # The reference polls MPS daemons starting at 1s (sharing.go:
        # 290-296) because nvidia-cuda-mps-control starts slowly; a
        # coordinator publishes its ready file in tens of ms, so a
        # short-start 5 ms ramp sees a ready daemon within one probe
        # cycle, with the same ~20 s total patience.
        self.backoff = backoff or Backoff(duration_s=0.005, factor=2.0,
                                          jitter=0.1, steps=12,
                                          cap_s=10.0)

    def new_daemon(self, claim_uid: str, devices: list[AllocatableDevice],
                   settings: CoordinatedSettings,
                   preemption_ms: int = 0) -> CoordinatorDaemon:
        return CoordinatorDaemon(self, claim_uid, devices, settings,
                                 preemption_ms)

    def stop_by_id(self, coordinator_id: str) -> None:
        """Teardown from a checkpoint record (claim_uid lost on restart)."""
        name = f"tpu-coordinator-{coordinator_id}"
        try:
            self.client.delete("Deployment", self.namespace, name)
        except NotFoundError:
            pass
        shutil.rmtree(self.coordination_root / coordinator_id,
                      ignore_errors=True)
