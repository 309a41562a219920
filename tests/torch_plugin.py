"""Helpers of the plugin twins (tests/test_torch_plugin_state.py,
test_torch_driver_grpc.py, test_torch_health.py,
test_torch_cmd_plugin.py, test_torch_oop_plugin.py, and the
coordination twins): the claim builders, the coordinator-container
runner and the fake deployment controller of ``tests/helpers.py``,
written once for either package's objects (each package's beds run
that package's ``coordinatord``), and a snapshot of what a plugin wrote
to disk, with its root path masked so the two packages' trees compare
byte for byte."""

from __future__ import annotations

import importlib
import tempfile
from pathlib import Path

DRIVER = "tpu.google.com"


def short_dir(prefix: str) -> Path:
    """A directory under /tmp with a short path: unix socket paths stop
    at 107 bytes, which a pytest basetemp can pass."""
    return Path(tempfile.mkdtemp(prefix=prefix, dir="/tmp"))


def make_allocated_claim(pkg, name, assignments, configs=(),
                         namespace="default", pool="host", uid=None):
    """``tests/helpers.py``'s builder for ``pkg``'s objects, with a
    fixed uid (``uid-<name>`` by default) so both packages name their
    claim specs and coordinators alike."""
    r = pkg.resource
    alloc = r.AllocationResult(
        results=[r.DeviceRequestAllocationResult(
            request=req, driver=DRIVER, pool=pool, device=dev)
            for req, dev in assignments],
        config=[r.AllocatedDeviceConfig(
            source=src, requests=list(reqs),
            opaque=r.OpaqueConfig(driver=DRIVER, parameters=params))
            for src, reqs, params in configs])
    return r.ResourceClaim(
        metadata=r.ObjectMeta(name=name, namespace=namespace,
                              uid=uid or f"uid-{name}"),
        spec=r.ResourceClaimSpec(devices=r.DeviceClaim(
            requests=[r.DeviceRequest(name=req) for req, _ in assignments])),
        status=r.ResourceClaimStatus(allocation=alloc))


#: the coordinator template's command, the reference's console script
COORDINATOR_COMMAND = ["tpu-coordinatord"]


def resolve_mounts(pod_spec: dict) -> dict[str, str]:
    """containerPath -> hostPath for the first container's mounts."""
    vols = {v["name"]: v.get("hostPath", {}).get("path")
            for v in pod_spec.get("volumes", [])}
    ctr = pod_spec["containers"][0]
    return {m["mountPath"]: vols.get(m["name"])
            for m in ctr.get("volumeMounts", []) if vols.get(m["name"])}


def host_args(pod_spec: dict) -> list[str]:
    """The container's args with every ``--flag=<container path>``
    rewritten to the host path its mount maps it to."""
    mounts = resolve_mounts(pod_spec)
    args = []
    for arg in pod_spec["containers"][0].get("args", []):
        flag, eq, value = arg.partition("=")
        if eq:
            for cpath, hpath in mounts.items():
                if value == cpath or value.startswith(cpath + "/"):
                    value = hpath + value[len(cpath):]
                    break
        args.append(f"{flag}{eq}{value}" if eq else flag)
    return args


def coordinatord_of(pkg):
    return importlib.import_module(f"{pkg.name}.cmd.coordinatord")


def run_coordinator_container(coordinatord, pod_spec: dict) -> bool:
    """``tests/helpers.py``'s kubelet running a coordinator container,
    with ``coordinatord`` the package's daemon module: parse the
    rendered command and args with the daemon's own parser, map the
    container paths to host paths, run one daemon round in-process, and
    report whether the readiness probe (the ready file) would pass."""
    ctr = pod_spec["containers"][0]
    if ctr.get("command", []) != COORDINATOR_COMMAND:
        return False           # unknown binary: would crash-loop
    ns = coordinatord.build_parser().parse_args(host_args(pod_spec))
    policy_dir = Path(ns.policy_dir) if ns.policy_dir else None
    if policy_dir is not None and not policy_dir.is_dir():
        policy_dir = None
    coord = coordinatord.Coordinator(
        Path(ns.coordination_dir),
        duty_cycle_percent=ns.duty_cycle_percent,
        preemption_ms=ns.preemption_ms,
        hbm_limits=coordinatord._parse_hbm_limits(ns.hbm_limits),
        visible_chips=coordinatord._parse_chips(ns.visible_chips),
        policy_dir=policy_dir)
    coord.start()
    # the template's readiness probe: `cat /coordination/ready`
    return (Path(ns.coordination_dir) / coordinatord.READY_FILE).exists()


def start_fake_deployment_controller(pkg, cluster):
    """``tests/helpers.py``'s kubelet stand-in on ``pkg``'s cluster: a
    Deployment becomes ready only when its rendered coordinator command
    runs (``pkg``'s daemon) and publishes its ready file."""
    coordinatord = coordinatord_of(pkg)

    def on_event(event, obj):
        if event != pkg.cluster.EVENT_ADDED or \
                obj.ready_replicas >= obj.replicas:
            return
        pod_spec = obj.spec.get("template", {}).get("spec", {})
        containers = pod_spec.get("containers", [])
        if containers and containers[0].get("command"):
            if not run_coordinator_container(coordinatord, pod_spec):
                return
        obj.ready_replicas = obj.replicas
        cluster.update(obj)
    return cluster.watch("Deployment", on_event)


#: what a plugin writes that must match across packages: CDI specs,
#: checkpoint generations, time-slicing policies, coordinator policies
SNAPSHOT_GLOBS = ("cdi/*.json", "plugin/checkpoint.json*",
                  "plugin/policy/*.json", "plugin/coordinator/*/policy.json")


def snapshot(root: Path) -> dict[str, str]:
    """Relative path -> text of every file of ``SNAPSHOT_GLOBS`` under
    ``root``, with ``root`` itself written as ``<ROOT>``."""
    root = Path(root)
    out = {}
    for pattern in SNAPSHOT_GLOBS:
        for path in sorted(root.glob(pattern)):
            out[path.relative_to(root).as_posix()] = \
                path.read_text().replace(str(root), "<ROOT>")
    return out
