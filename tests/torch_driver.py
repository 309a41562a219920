"""Helpers of the driver twins (tests/test_torch_discovery.py,
test_torch_native_discovery.py, test_torch_devicemodel.py,
test_torch_configapi.py, test_torch_allocator.py,
test_torch_native_alloc.py, and the plugin's: test_torch_plugin_state.py,
test_torch_driver_grpc.py, test_torch_health.py,
test_torch_rest_client.py, test_torch_cmd_plugin.py,
test_torch_oop_plugin.py): one namespace per package, so a scenario
written once runs through the JAX package and through the port, and
the two results are compared."""

from __future__ import annotations

import dataclasses
import importlib
from types import SimpleNamespace


def _package(root: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        name=root, discovery=mod("discovery"),
        sysfs=mod("discovery.sysfs"), native=mod("discovery.native"),
        devicemodel=mod("devicemodel"), resource=mod("api.resource"),
        classes=mod("api.classes"), configapi=mod("api.config.v1alpha1"),
        quantity=mod("utils.quantity"), allocator=mod("allocator"),
        native_alloc=mod("allocator.native"), cluster=mod("cluster"),
        objects=mod("cluster.objects"), plugin=mod("plugin"),
        cdi=mod("plugin.cdi"), cdi_schema=mod("plugin.cdi_schema"),
        sharing=mod("plugin.sharing"), health=mod("plugin.health"),
        device_state=mod("plugin.device_state"), proto=mod("proto"),
        services=mod("proto.services"), cmd_plugin=mod("cmd.plugin"),
        rest=mod("cluster.rest"), flags=mod("utils.flags"),
        info=mod("utils.info"), metrics=mod("utils.metrics"),
        httpendpoint=mod("utils.httpendpoint"),
        backoff=mod("utils.backoff"))


JAX = _package("k8s_dra_driver_tpu")
PORT = _package("k8s_dra_driver_tpu_torch")
BOTH = (JAX, PORT)


def as_dict(obj):
    return dataclasses.asdict(obj)


def devices_of(pkg, topo, kinds=None):
    """``to_device()`` of every allocatable device, in name order."""
    dm = pkg.devicemodel
    devs = (dm.enumerate_host_devices(topo) if kinds is None
            else dm.enumerate_host_devices(topo, kinds=kinds))
    return [d.to_device() for _, d in sorted(devs.items())]


def slices_for(pkg, devices, names):
    """One node-local ResourceSlice and one Node per name, each
    publishing ``devices`` (a list of the package's Devices)."""
    r = pkg.resource
    slices = [r.ResourceSlice(
        metadata=r.ObjectMeta(name=f"s-{n}"), driver="tpu.google.com",
        pool=r.ResourcePool(name=n), node_name=n, devices=list(devices))
        for n in names]
    nodes = [pkg.cluster.Node(metadata=r.ObjectMeta(name=n)) for n in names]
    return slices, nodes


def request(pkg, name="r0", count=1, cls="tpu.google.com", selectors=(),
            mode=""):
    r = pkg.resource
    return r.DeviceRequest(
        name=name, device_class_name=cls, count=count,
        allocation_mode=mode or r.ALLOCATION_MODE_EXACT,
        selectors=[r.DeviceSelector(cel=s) for s in selectors])


def claim(pkg, requests, constraints=(), configs=(), name="c"):
    r = pkg.resource
    return r.ResourceClaim(
        metadata=r.ObjectMeta(name=name, namespace="default"),
        spec=r.ResourceClaimSpec(devices=r.DeviceClaim(
            requests=list(requests), constraints=list(constraints),
            config=list(configs))))


def constraint(pkg, attr, requests=()):
    return pkg.resource.DeviceConstraint(requests=list(requests),
                                         match_attribute=attr)


def picks(result):
    return sorted((x.request, x.pool, x.device) for x in result.results)


def outcome(fn):
    """``fn()``'s allocation as sorted picks, or the AllocationError's
    message."""
    try:
        return picks(fn())
    except (JAX.allocator.AllocationError,
            PORT.allocator.AllocationError) as e:
        return ("AllocationError", str(e))
