"""``tpu-dra-plugin`` — the per-node kubelet plugin binary.

The port's copy of ``k8s_dra_driver_tpu/cmd/plugin.py``, run as
``python -m k8s_dra_driver_tpu_torch.cmd.plugin``: the same flags, env
mirrors and defaults.  On an NVIDIA host discovery finds the cards
(``/dev/nvidia<minor>``, and NVML where a sandbox hides the driver's
procfs) and the CDI specs carry the NVIDIA container contract
(plugin/cdi.py).  Its import graph loads no ``torch``.

The analog of the reference's plugin entrypoint (reference
cmd/nvidia-dra-plugin/main.go:36-206): flag parsing with env mirrors,
plugin/CDI directory creation, driver construction, and a signal loop.
Differences are deliberate choices:

- discovery is sysfs/env (``--driver-root`` prefixes a host mount), not
  a driver-library path hunt first;
- ``--device-classes`` gates which device *kinds* are enumerated
  (chip/core/slice — the gpu/mig gating analog, main.go:117-123 and
  nvlib.go:113-133);
- the plugin serves Prometheus metrics too (``--http-endpoint``), which
  the reference's plugin does not.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
from pathlib import Path

from ..devicemodel import KIND_CHIP, KIND_CORE, KIND_SLICE
from ..utils import info
from ..utils.flags import KubeClientConfig, LoggingConfig, env_default
from ..utils.metrics import DriverMetrics

log = logging.getLogger("tpu-dra-plugin")

DEFAULT_PLUGIN_ROOT = "/var/lib/kubelet/plugins/tpu.google.com"
DEFAULT_REGISTRAR_ROOT = "/var/lib/kubelet/plugins_registry"
DEFAULT_CDI_ROOT = "/var/run/cdi"

_KIND_BY_CLASS = {"chip": KIND_CHIP, "core": KIND_CORE, "slice": KIND_SLICE}
# Cluster-level classes the controller handles; the plugin accepts and
# ignores them so one DEVICE_CLASSES value serves both binaries (the
# chart wires the same list into each).
_CONTROLLER_CLASSES = {"rendezvous", "podslice"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-dra-plugin",
        description="TPU DRA kubelet plugin (tpu.google.com)")
    p.add_argument("--version", action="version",
                   version=info.get_version_string())
    p.add_argument("--node-name",
                   default=env_default("NODE_NAME"),
                   help="name of the Node this plugin runs on "
                        "[env NODE_NAME] (required)")
    p.add_argument("--plugin-root",
                   default=env_default("PLUGIN_ROOT", DEFAULT_PLUGIN_ROOT),
                   help="kubelet plugin dir for socket + checkpoint "
                        "[env PLUGIN_ROOT]")
    p.add_argument("--registrar-root",
                   default=env_default("REGISTRAR_ROOT",
                                       DEFAULT_REGISTRAR_ROOT),
                   help="kubelet plugin-registry dir for the registration "
                        "socket [env REGISTRAR_ROOT]")
    p.add_argument("--cdi-root",
                   default=env_default("CDI_ROOT", DEFAULT_CDI_ROOT),
                   help="directory CDI spec files are written to "
                        "[env CDI_ROOT]")
    p.add_argument("--driver-root",
                   default=env_default("DRIVER_ROOT", "/"),
                   help="host filesystem mount prefix for sysfs/dev probing "
                        "when containerized [env DRIVER_ROOT]")
    p.add_argument("--host-driver-root",
                   default=env_default("HOST_DRIVER_ROOT", None),
                   help="the driver root as the node sees it, which CDI "
                        "mounts' hostPaths name; default: --driver-root "
                        "[env HOST_DRIVER_ROOT]")
    p.add_argument("--device-classes",
                   default=env_default("DEVICE_CLASSES", "chip,core,slice"),
                   help="comma list of device kinds to enumerate: "
                        "chip,core,slice [env DEVICE_CLASSES]")
    p.add_argument("--coordinator-namespace",
                   default=env_default("COORDINATOR_NAMESPACE",
                                       "tpu-dra-driver"),
                   help="namespace coordinator daemons are created in "
                        "[env COORDINATOR_NAMESPACE]")
    p.add_argument("--coordinator-image",
                   default=env_default("COORDINATOR_IMAGE", ""),
                   help="image for per-claim coordinator Deployments "
                        "(the driver image — it ships tpu-coordinatord); "
                        "REQUIRED before Coordinated claims can prepare: "
                        "left empty, such claims fail in-band "
                        "[env COORDINATOR_IMAGE]")
    p.add_argument("--http-endpoint",
                   default=env_default("HTTP_ENDPOINT", ""),
                   help="host:port for /metrics + /healthz; empty disables "
                        "[env HTTP_ENDPOINT]")
    p.add_argument("--health-interval", type=float,
                   default=env_default("HEALTH_INTERVAL", "30"),
                   help="seconds between chip-health probes (device-node "
                        "presence + sysfs health attrs); failed chips are "
                        "unpublished from ResourceSlices; 0 disables "
                        "[env HEALTH_INTERVAL]")
    p.add_argument("--fake-topology",
                   default=env_default("FAKE_TOPOLOGY", ""),
                   help="path to a fake-host JSON spec; uses the hermetic "
                        "discovery backend [env FAKE_TOPOLOGY]")
    p.add_argument("--discovery", choices=("sysfs", "native", "auto"),
                   default=env_default("DISCOVERY", "sysfs"),
                   help="enumeration backend: pure-Python sysfs parser, "
                        "the C++ shim, or auto (native with sysfs "
                        "fallback) [env DISCOVERY]")
    p.add_argument("--visible-chips",
                   default=env_default("VISIBLE_CHIPS", ""),
                   help="mask discovery to these host-local chip "
                        "indices: a comma list (e.g. 0,1) or @<file> "
                        "carrying one, resolved under --driver-root "
                        "(per-worker masking: the file rides each "
                        "worker's host mount — the nvkind params-file "
                        "analog); empty = all chips "
                        "[env VISIBLE_CHIPS]")
    KubeClientConfig.add_flags(p)
    LoggingConfig.add_flags(p)
    return p


def validate(args: argparse.Namespace) -> None:
    if not args.node_name:
        raise SystemExit("--node-name (or NODE_NAME) is required")
    kinds = [k.strip() for k in args.device_classes.split(",") if k.strip()]
    bad = [k for k in kinds
           if k not in _KIND_BY_CLASS and k not in _CONTROLLER_CLASSES]
    if bad:
        raise SystemExit(
            f"unknown device class(es) {bad}; valid: "
            f"{sorted(_KIND_BY_CLASS) + sorted(_CONTROLLER_CLASSES)}")
    node_kinds = [k for k in kinds if k in _KIND_BY_CLASS]
    if not node_kinds:
        raise SystemExit("--device-classes must name at least one "
                         "node-level class (chip, core, slice)")
    args.device_kinds = tuple(_KIND_BY_CLASS[k] for k in node_kinds)


def build_backend(args: argparse.Namespace):
    if args.fake_topology:
        import json
        import tempfile
        from ..discovery import FakeHost
        spec = json.loads(Path(args.fake_topology).read_text())
        if "worker_hostnames" in spec:
            spec["worker_hostnames"] = tuple(spec["worker_hostnames"])
        # optional "root": materialize at a caller-known path so tests
        # can mutate the tree (health files) while the plugin runs
        root = spec.pop("root", None) or tempfile.mkdtemp(
            prefix="tpu-fake-")
        host = FakeHost(**spec)
        return host.materialize(Path(root))
    if args.discovery in ("native", "auto"):
        from ..discovery.native import NativeBackend, NativeUnavailableError
        try:
            return NativeBackend(host_root=args.driver_root)
        except NativeUnavailableError:
            if args.discovery == "native":
                raise
            log.warning("native discovery unavailable; falling back to "
                        "sysfs backend")
    from ..discovery import SysfsBackend
    return SysfsBackend(host_root=args.driver_root)


def mask_backend(args: argparse.Namespace, backend):
    """Apply the --visible-chips mask (nvkind per-worker partitioning
    analog) around whatever backend discovery chose — including an
    injected fake one, so masking composes with every test tier."""
    from ..discovery import MaskedBackend, parse_visible_chips
    visible = parse_visible_chips(args.visible_chips, args.driver_root)
    if visible is None:
        return backend
    log.info("masking discovery to visible chips %s", sorted(visible))
    return MaskedBackend(backend, visible)


def run(args: argparse.Namespace, client=None, backend=None,
        ready_event: threading.Event | None = None,
        stop_event: threading.Event | None = None) -> int:
    """Build and run the plugin until signalled.  ``client``/``backend``
    injection keeps this path hermetically testable."""
    from ..plugin import DeviceState, DeviceStateConfig, Driver

    validate(args)
    LoggingConfig.apply(args)
    log.info("%s starting (version %s) on node %s",
             "tpu-dra-plugin", info.get_version_string(), args.node_name)

    # mkdir plugin + cdi dirs up front (StartPlugin analog, main.go:171-181)
    for d in (args.plugin_root, args.registrar_root, args.cdi_root):
        Path(d).mkdir(parents=True, exist_ok=True)

    client = client or KubeClientConfig.build_client(args)
    backend = mask_backend(args, backend or build_backend(args))

    # Deterministic fault injection (test/chaos tooling): a plan file
    # named by TPU_DRA_FAULT_PLAN scripts API-call failures and named
    # crash windows into this process (cluster/faults.py).
    from ..cluster import faults
    fault_plan = faults.load_plan_from_env()
    if fault_plan is not None:
        faults.install_process_plan(fault_plan)
        client = faults.FaultyClusterClient(client, fault_plan)
        log.warning("fault injection ACTIVE: %d rule(s) from $%s",
                    len(fault_plan.rules), faults.FAULT_PLAN_ENV)

    state = DeviceState(backend, client, DeviceStateConfig(
        plugin_root=args.plugin_root, cdi_root=args.cdi_root,
        node_name=args.node_name, driver_root=args.driver_root,
        host_driver_root=args.host_driver_root,
        device_kinds=args.device_kinds,
        coordinator_namespace=args.coordinator_namespace,
        coordinator_image=args.coordinator_image))
    metrics = DriverMetrics()
    driver = Driver(state, client, args.plugin_root, metrics=metrics,
                    registrar_dir=args.registrar_root)

    endpoint = None
    if args.http_endpoint:
        from ..utils.httpendpoint import HTTPEndpoint
        endpoint = HTTPEndpoint(args.http_endpoint, metrics)
        endpoint.start()
        log.info("serving metrics on %s", endpoint.address)

    stop = stop_event or threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # not on the main thread (tests)

    driver.start()
    monitor = None
    if args.health_interval > 0:
        from ..plugin.health import HealthMonitor
        monitor = HealthMonitor(driver, backend,
                                interval=args.health_interval)
        monitor.check_once()       # surface boot-time failures at once
        monitor.start()
        log.info("health monitor polling every %.0fs",
                 args.health_interval)
    log.info("driver started: %d allocatable devices, sockets at %s",
             len(state.allocatable), driver.plugin_socket)
    if ready_event is not None:
        ready_event.set()
    try:
        # deadline: process-lifetime wait; SIGTERM/SIGINT set the
        # event (the reference blocks the same way, main.go run()).
        stop.wait()
    finally:
        log.info("shutting down")
        if monitor:
            monitor.stop()
        driver.shutdown()
        if endpoint:
            endpoint.stop()
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
