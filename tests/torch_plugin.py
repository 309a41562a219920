"""Helpers of the plugin twins (tests/test_torch_plugin_state.py,
test_torch_driver_grpc.py, test_torch_health.py,
test_torch_cmd_plugin.py, test_torch_oop_plugin.py): the claim
builders and the fake deployment controller of ``tests/helpers.py``,
written once for either package's objects, and a snapshot of what a
plugin wrote to disk, with its root path masked so the two packages'
trees compare byte for byte."""

from __future__ import annotations

import tempfile
from pathlib import Path

from helpers import _run_coordinator_container

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


def start_fake_deployment_controller(pkg, cluster):
    """``tests/helpers.py``'s kubelet stand-in on ``pkg``'s cluster: a
    Deployment becomes ready only when its rendered coordinator command
    runs and publishes its ready file."""
    def on_event(event, obj):
        if event != pkg.cluster.EVENT_ADDED or \
                obj.ready_replicas >= obj.replicas:
            return
        pod_spec = obj.spec.get("template", {}).get("spec", {})
        containers = pod_spec.get("containers", [])
        if containers and containers[0].get("command"):
            if not _run_coordinator_container(pod_spec):
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
