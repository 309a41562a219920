"""DeviceState: the node-side claim state machine.

The port's copy of ``k8s_dra_driver_tpu/plugin/device_state.py``.  On a
TPU host every spec and checkpoint it writes equals the reference's; on
an NVIDIA host (cdi.py ``is_nvidia_host``) the standard spec carries the
NVIDIA common edits and the claim spec ``CUDA_VISIBLE_DEVICES`` by GPU
UUID in place of the chip, core and host-bounds variables.  The analog of the reference's DeviceState (reference
cmd/nvidia-dra-plugin/device_state.go:45-510): enumerate allocatable
devices once at startup, then serve Prepare/Unprepare with

- checkpoint-backed idempotency across plugin restarts
  (device_state.go:128-190),
- opaque-config precedence resolution — claim configs beat class
  configs, later entries beat earlier ones, type-checked per device
  kind, with per-kind defaults at lowest precedence
  (device_state.go:192-299,457-510),
- config application fan-out to the sharing managers and rendezvous
  injection (device_state.go:367-444),
- per-claim CDI spec generation carrying claim-scoped edits.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from ..api import resource
from ..api.config import v1alpha1 as configapi
from ..cluster import ClusterClient
from ..devicemodel import (AllocatableDevice, KIND_CHIP, KIND_CORE,
                           KIND_PODSLICE, KIND_RENDEZVOUS, KIND_SLICE,
                           PreparedClaim, PreparedDevice,
                           enumerate_host_devices)
from ..discovery import DiscoveryBackend
from .cdi import (CDIHandler, ContainerEdits, claim_topology_edits,
                  is_nvidia_host)
from .checkpoint import CheckpointManager
from .sharing import CoordinatorManager, TimeSlicingManager

DRIVER_NAME = "tpu.google.com"


class PrepareError(RuntimeError):
    pass


@dataclasses.dataclass
class DeviceStateConfig:
    plugin_root: str
    cdi_root: str
    node_name: str
    driver_root: str = "/"
    #: the driver root as the node sees it, for CDI hostPaths (None: the
    #: driver root)
    host_driver_root: str | None = None
    device_kinds: tuple[str, ...] = (KIND_CHIP, KIND_CORE, KIND_SLICE)
    coordinator_namespace: str = "tpu-dra-driver"
    coordinator_image: str = ""      # required before a coordinated
                                     # claim can prepare (sharing.py
                                     # raises in-band otherwise)


# Which config kinds may govern which device kinds.
_KIND_COMPAT = {
    configapi.TpuChipConfig: {KIND_CHIP, KIND_SLICE},
    configapi.TpuPartitionConfig: {KIND_CORE},
    configapi.RendezvousConfig: {KIND_RENDEZVOUS, KIND_PODSLICE},
}


@dataclasses.dataclass
class _ResolvedConfig:
    """One opaque config plus the requests it governs (the reference's
    per-result config resolution output, device_state.go:225-259)."""

    config: object
    requests: list[str]           # empty = catch-all
    source_is_claim: bool = False
    is_default: bool = False


class DeviceState:
    def __init__(self, backend: DiscoveryBackend, client: ClusterClient,
                 config: DeviceStateConfig):
        self.config = config
        self.client = client
        self.topology = backend.enumerate()
        self.allocatable = enumerate_host_devices(
            self.topology, kinds=config.device_kinds)
        # full enumeration, untouched by health filtering
        self.all_allocatable = dict(self.allocatable)
        self.unhealthy: dict[int, str] = {}
        self.nvidia = is_nvidia_host(self.topology)
        self.cdi = CDIHandler(config.cdi_root, config.driver_root,
                              config.host_driver_root)
        self.cdi.create_standard_spec(self.allocatable,
                                      self.topology.libtpu_path,
                                      nvidia=self.nvidia)
        self.checkpoints = CheckpointManager(config.plugin_root)
        self.timeslicing = TimeSlicingManager(config.plugin_root)
        coord_kwargs = {}
        if config.coordinator_image:
            coord_kwargs["image"] = config.coordinator_image
        self.coordinators = CoordinatorManager(
            client, config.plugin_root, config.node_name,
            namespace=config.coordinator_namespace, **coord_kwargs)
        self._lock = threading.Lock()
        self.prepared: dict[str, PreparedClaim] = self.checkpoints.load()

    # ------------------------------------------------------------------
    # Prepare
    # ------------------------------------------------------------------

    def prepare(self, claim: resource.ResourceClaim) -> PreparedClaim:
        with self._lock:
            uid = claim.metadata.uid
            if uid in self.prepared:           # idempotent early-return
                return self.prepared[uid]
            if claim.status.allocation is None:
                raise PrepareError(
                    f"claim {claim.metadata.name} has no allocation")
            prepared, config_edits = self._prepare_devices(claim)
            edits = self._claim_edits(claim, prepared, config_edits)
            self.cdi.create_claim_spec(uid, edits)
            self.prepared[uid] = prepared
            self.checkpoints.save(self.prepared)
            return prepared

    def _prepare_devices(
            self, claim: resource.ResourceClaim
    ) -> tuple[PreparedClaim, ContainerEdits]:
        alloc = claim.status.allocation
        uid = claim.metadata.uid
        results = [r for r in alloc.results if r.driver in ("", DRIVER_NAME)]

        configs = self._resolve_configs(alloc)
        prepared = PreparedClaim(
            claim_uid=uid, claim_namespace=claim.metadata.namespace,
            claim_name=claim.metadata.name)

        # Group results by the config that governs them, then apply each
        # config once over its device group (applyConfig fan-out analog).
        groups: dict[int, list[resource.DeviceRequestAllocationResult]] = {}
        for res in results:
            idx = self._config_for_result(res, configs)
            groups.setdefault(idx, []).append(res)

        extra_edits = ContainerEdits()
        for idx, group in sorted(groups.items()):
            cfg = configs[idx].config
            devices = [self._lookup(res) for res in group]
            edits = self._apply_config(uid, cfg, devices, prepared)
            if edits is not None:
                extra_edits.merge(edits)
            for res, dev in zip(group, devices):
                if dev.kind in (KIND_RENDEZVOUS, KIND_PODSLICE):
                    # Controller-published device: it has no entry in this
                    # node's standard CDI spec, everything it injects rides
                    # on the per-claim spec.
                    cdi_ids = [self.cdi.claim_device_id(uid)]
                else:
                    cdi_ids = [self.cdi.standard_device_id(dev.name),
                               self.cdi.claim_device_id(uid)]
                prepared.devices.append(PreparedDevice(
                    request=res.request, kind=dev.kind,
                    device_name=dev.name, pool=res.pool,
                    uuids=dev.uuids,
                    chip_indices=sorted(c.index for c in dev.chips),
                    cdi_device_ids=cdi_ids,
                    core_index=dev.core_index))
        # Config-derived edits travel as an explicit return value (not
        # instance state) so an early return can never leak one claim's
        # edits into the next prepare.
        return prepared, extra_edits

    def apply_health(self, unhealthy: dict[int, str]) -> bool:
        """Filter the allocatable set to chips not in ``unhealthy``
        (chip index -> reason).  Every device touching a failed chip
        disappears — the chip itself, its core partitions, and every
        pre-enumerated slice containing it — so the scheduler cannot
        place new claims on broken hardware.  Already-prepared claims
        are untouched (kubelet tears them down on pod deletion as
        usual).  Returns True when the set changed (caller republishes
        ResourceSlices).  No reference analog: the reference keeps
        publishing a failed GPU until an operator intervenes.
        """
        with self._lock:
            if unhealthy == self.unhealthy:
                return False
            self.unhealthy = dict(unhealthy)
            self.allocatable = {
                name: dev for name, dev in self.all_allocatable.items()
                if not any(c.index in unhealthy for c in dev.chips)}
            return True

    def _lookup(self, res) -> AllocatableDevice:
        dev = self.allocatable.get(res.device)
        if dev is None:
            sick = self.all_allocatable.get(res.device)
            if sick is not None:       # known device, filtered by health
                reasons = "; ".join(
                    self.unhealthy[c.index] for c in sick.chips
                    if c.index in self.unhealthy)
                raise PrepareError(
                    f"allocated device {res.device!r} is unhealthy on "
                    f"node {self.config.node_name}: {reasons}")
            dev = self._synthesize_cluster_device(res.device)
        if dev is None:
            raise PrepareError(
                f"allocated device {res.device!r} does not exist on node "
                f"{self.config.node_name}")
        return dev

    def _synthesize_cluster_device(self,
                                   name: str) -> AllocatableDevice | None:
        """Materialize controller-published gang devices at prepare time.

        Rendezvous channels and podslice gang devices live in
        slice-scoped pools the *controller* publishes; the node plugin
        still prepares them — the analog of the reference plugin
        mknod'ing IMEX channel devices it never published itself
        (reference device_state.go:430-444, nvlib.go:490-519)."""
        sl = self.topology.slice
        if name.startswith("channel-"):
            try:
                channel_id = int(name.removeprefix("channel-"))
            except ValueError:
                return None
            return AllocatableDevice(
                KIND_RENDEZVOUS, (), channel_id=channel_id,
                slice_id=sl.slice_id if sl else "")
        if name == "podslice" and sl is not None:
            if self.unhealthy:
                # a gang member with a dead chip would join the slice
                # with a partial mesh — fail the prepare in-band
                # instead (the health filter covers pre-enumerated
                # devices; synthesized gang devices must check too)
                reasons = "; ".join(
                    f"chip {i}: {r}"
                    for i, r in sorted(self.unhealthy.items()))
                raise PrepareError(
                    f"podslice gang prepare refused on node "
                    f"{self.config.node_name}: {reasons}")
            return AllocatableDevice(
                KIND_PODSLICE, tuple(self.topology.chips),
                slice_id=sl.slice_id)
        return None

    # -- config resolution ------------------------------------------------

    def _resolve_configs(
            self, alloc: resource.AllocationResult) -> list[_ResolvedConfig]:
        """Build the precedence-ordered candidate list: defaults first
        (lowest), then class configs, then claim configs; within a source,
        later entries win because matching walks the list in reverse
        (GetOpaqueDeviceConfigs + defaults-insertion analog,
        device_state.go:210-221,457-510)."""
        out: list[_ResolvedConfig] = [
            _ResolvedConfig(configapi.TpuChipConfig.default(), [],
                            is_default=True),
            _ResolvedConfig(configapi.TpuPartitionConfig.default(), [],
                            is_default=True),
            _ResolvedConfig(configapi.RendezvousConfig.default(), [],
                            is_default=True),
        ]
        ordered = sorted(
            alloc.config,
            key=lambda c: c.source == resource.CONFIG_SOURCE_CLAIM)
        for entry in ordered:
            if entry.opaque is None or entry.opaque.driver != DRIVER_NAME:
                continue
            try:
                cfg = configapi.decode(entry.opaque.parameters)
                cfg.normalize()
                cfg.validate()
            except configapi.ConfigError as e:
                raise PrepareError(f"invalid opaque config: {e}") from e
            out.append(_ResolvedConfig(
                cfg, list(entry.requests),
                source_is_claim=entry.source == resource.CONFIG_SOURCE_CLAIM))
        return out

    def _config_for_result(self, res, configs: list[_ResolvedConfig]) -> int:
        dev = self._lookup(res)
        for idx in range(len(configs) - 1, -1, -1):
            cand = configs[idx]
            scoped = res.request in cand.requests
            if cand.requests and not scoped:
                continue
            compatible = dev.kind in _KIND_COMPAT.get(type(cand.config), set())
            if compatible:
                return idx
            if scoped:
                raise PrepareError(
                    f"config {type(cand.config).__name__} is scoped to "
                    f"request {res.request!r} but cannot govern a "
                    f"{dev.kind} device")
        raise PrepareError(f"no config matches request {res.request!r}")

    # -- config application ----------------------------------------------

    def _apply_config(self, claim_uid: str, cfg, devices, prepared
                      ) -> ContainerEdits | None:
        if isinstance(cfg, (configapi.TpuChipConfig,
                            configapi.TpuPartitionConfig)):
            return self._apply_sharing(claim_uid, cfg.sharing, devices,
                                       prepared)
        if isinstance(cfg, configapi.RendezvousConfig):
            return self._apply_rendezvous(cfg, devices)
        raise PrepareError(f"unhandled config type {type(cfg).__name__}")

    def _apply_sharing(self, claim_uid: str, sharing, devices, prepared
                       ) -> ContainerEdits | None:
        if sharing.strategy == configapi.STRATEGY_TIME_SLICING:
            chips = self.timeslicing.set_time_slice(devices,
                                                    sharing.time_slicing)
            prepared.timesliced_chips.extend(chips)
            edits = ContainerEdits()
            edits.env["TPU_RUNTIME_PREEMPTION_MS"] = str(
                sharing.time_slicing.interval_ms)
            # The quantum's enforcement point: tpu-coordclient contends
            # for per-chip flocks in the node timeshare dir, so claims
            # sharing a chip get kernel-enforced alternation (the GPU
            # scheduler-knob analog, nvlib.go:521-539).
            edits.env["TPU_TIMESHARE_DIR"] = \
                TimeSlicingManager.CONTAINER_TIMESHARE_DIR
            edits.mounts.append(
                (str(self.timeslicing.timeshare_dir),
                 TimeSlicingManager.CONTAINER_TIMESHARE_DIR,
                 ("rw", "bind")))
            return edits
        if sharing.strategy == configapi.STRATEGY_COORDINATED:
            daemon = self.coordinators.new_daemon(
                claim_uid, devices, sharing.coordinated)
            daemon.start()
            daemon.assert_ready(sleep=self._sleep)
            prepared.coordinator_ids.append(daemon.id)
            return daemon.cdi_edits()
        return None

    def _apply_rendezvous(self, cfg: configapi.RendezvousConfig, devices
                          ) -> ContainerEdits:
        """Wire a gang claim to its slice rendezvous (the prepare-time
        IMEX-channel injection analog, device_state.go:430-444 +
        nvlib.go:490-519 — a config projection instead of mknod)."""
        edits = ContainerEdits()
        sl = self.topology.slice
        if sl is not None:
            coord = sl.coordinator_address or self.topology.hostname
            edits.env["TPU_TOPOLOGY"] = str(sl.topology)
            edits.env["TPU_WORKER_ID"] = str(sl.worker_id)
            # explicit gang size: hostnames are empty when an external
            # coordinator address is configured, so consumers
            # (parallel/rendezvous.py) must not have to infer N
            edits.env["TPU_NUM_WORKERS"] = str(sl.num_workers)
            edits.env["TPU_WORKER_HOSTNAMES"] = ",".join(
                f"{sl.slice_id}-w{i}" for i in range(sl.num_workers)) \
                if not sl.coordinator_address else ""
            edits.env["TPU_COORDINATOR_ADDRESS"] = f"{coord}:{cfg.port}"
            edits.env["TPU_RENDEZVOUS_BARRIER_TIMEOUT_S"] = str(
                cfg.barrier_timeout_s)
        for dev in devices:
            if dev.kind == KIND_RENDEZVOUS:
                edits.env["TPU_RENDEZVOUS_CHANNEL"] = str(dev.channel_id)
            elif dev.kind == KIND_PODSLICE:
                # the gang device grants this host's chips
                for chip in dev.chips:
                    edits.device_nodes.extend(chip.dev_paths)
        return edits

    # -- claim-level CDI edits -------------------------------------------

    def _claim_edits(self, claim: resource.ResourceClaim,
                     prepared: PreparedClaim,
                     config_edits: ContainerEdits) -> ContainerEdits:
        bounds = ""
        if self.topology.chips:
            bounds_shape = self.topology.host_bounds
            bounds = f"{bounds_shape.x},{bounds_shape.y},{bounds_shape.z}"
        slice_env: dict[str, str] = {}
        sl = self.topology.slice
        if sl is not None:
            slice_env["TPU_SLICE_ID"] = sl.slice_id
        card_uuids = ({c.index: c.uuid for c in self.topology.chips}
                      if self.nvidia else None)
        edits = claim_topology_edits(prepared, host_bounds=bounds,
                                     slice_env=slice_env,
                                     card_uuids=card_uuids)
        edits.merge(config_edits)
        # Drop empty env vars (e.g. unset worker hostnames).
        edits.env = {k: v for k, v in edits.env.items() if v != ""}
        return edits

    # ------------------------------------------------------------------
    # Unprepare
    # ------------------------------------------------------------------

    def unprepare(self, claim_uid: str) -> None:
        with self._lock:
            prepared = self.prepared.get(claim_uid)
            if prepared is None:              # unknown claim: no-op
                return
            for coord_id in prepared.coordinator_ids:
                self.coordinators.stop_by_id(coord_id)
            if prepared.timesliced_chips:
                self.timeslicing.reset(prepared.timesliced_chips)
            self.cdi.delete_claim_spec(claim_uid)
            del self.prepared[claim_uid]
            self.checkpoints.save(self.prepared)

    # Injection point for tests (no real sleeping in unit tests).
    _sleep = staticmethod(time.sleep)
