"""In-process end-to-end bed over the port (the twin of tests/testbed.py
``E2EBed``): fake hosts, a fake cluster, the port's kubelet plugins
serving real gRPC on unix sockets, the port's slice-gang controller
watching Nodes, the port's allocator standing in for kube-scheduler and
a mini CDI interpreter standing in for the container runtime; coordinator
Deployments are run by the port's ``coordinatord``.  Every socket lives
under a short ``/tmp`` directory (unix socket paths stop at 107 bytes),
which ``shutdown`` removes."""

from __future__ import annotations

import shutil
from pathlib import Path

import grpc

from k8s_dra_driver_tpu_torch.allocator import allocate_claim
from k8s_dra_driver_tpu_torch.api import resource
from k8s_dra_driver_tpu_torch.api.classes import standard_device_classes
from k8s_dra_driver_tpu_torch.cluster import (FakeCluster, FaultPlan,
                                              FaultyClusterClient, Node)
from k8s_dra_driver_tpu_torch.controller import SliceGangController
from k8s_dra_driver_tpu_torch.discovery import FakeHost
from k8s_dra_driver_tpu_torch.plugin import (DeviceState, DeviceStateConfig,
                                             Driver)
from k8s_dra_driver_tpu_torch.proto import DRAPluginStub, dra_pb2
from k8s_dra_driver_tpu_torch.utils.backoff import Backoff

from testbed import PodView, apply_cdi
from torch_driver import PORT
from torch_plugin import short_dir, start_fake_deployment_controller


class PortE2EBed:
    def __init__(self, hosts: list[FakeHost], with_controller: bool = True,
                 fault_plan: FaultPlan | None = None):
        self.tmp = short_dir("te2e-")
        self.cluster = FakeCluster()
        # the drivers' and the controller's API calls go through the
        # fault plan when one is given; the bed's own calls (nodes,
        # classes, claims) use the raw cluster, so a scripted outage
        # breaks the system under test and not the harness
        self.fault_plan = fault_plan
        self.client = (FaultyClusterClient(self.cluster, fault_plan)
                       if fault_plan is not None else self.cluster)
        start_fake_deployment_controller(PORT, self.cluster)
        self.classes = standard_device_classes()
        for cls in self.classes.values():
            self.cluster.create(cls)
        self.drivers: dict[str, Driver] = {}
        self.hosts: dict[str, FakeHost] = {}
        #: each host's discovery backend over its fake tree
        self.backends: dict = {}
        self.controller = None
        if with_controller:
            self.controller = SliceGangController(self.client,
                                                  retry_delay_s=0.01)
            self.controller.start()
        try:
            for host in hosts:
                self.add_host(host)
        except Exception:
            self.shutdown()
            raise

    def _spawn_driver(self, host: FakeHost) -> Driver:
        """One construction for first start and restart."""
        name = host.hostname
        backend = host.materialize(self.tmp / "hosts" / name)
        self.backends[name] = backend
        state = DeviceState(backend, self.client, DeviceStateConfig(
            plugin_root=str(self.tmp / "plugin" / name),
            cdi_root=str(self.tmp / "cdi" / name),
            node_name=name,
            coordinator_image="registry.local/tpu-dra-driver:test"))
        driver = Driver(state, self.client,
                        plugin_dir=str(self.tmp / "plugin" / name),
                        publish_backoff=Backoff(
                            duration_s=0.01, factor=2.0, jitter=0,
                            steps=10, cap_s=0.1, deadline_s=10.0))
        driver.start()
        self.drivers[name] = driver
        return driver

    def add_host(self, host: FakeHost) -> Driver:
        self.hosts[host.hostname] = host
        self.cluster.create(Node(metadata=resource.ObjectMeta(
            name=host.hostname)))
        return self._spawn_driver(host)

    def restart_driver(self, name: str) -> Driver:
        """A kubelet-plugin pod restart on one node, over the same
        plugin dir (checkpoint) and host backend."""
        self.drivers[name].shutdown()
        return self._spawn_driver(self.hosts[name])

    def restart_controller(self) -> None:
        """A controller pod restart: stop cleans up owned slices, the
        new instance re-publishes."""
        assert self.controller is not None
        self.controller.stop()
        self.controller = SliceGangController(self.client,
                                              retry_delay_s=0.01)
        self.controller.start()

    def shutdown(self) -> None:
        for d in self.drivers.values():
            d.shutdown()
        if self.controller:
            self.controller.stop()
        shutil.rmtree(self.tmp, ignore_errors=True)

    # -- the kubelet/scheduler role --------------------------------------

    def create_claim(self, claim: resource.ResourceClaim
                     ) -> resource.ResourceClaim:
        return self.cluster.create(claim)

    def schedule(self, claim: resource.ResourceClaim) -> str:
        """Allocate and return the node the pod will land on."""
        allocate_claim(self.cluster, claim)
        selector = claim.status.allocation.node_selector or {}
        if "kubernetes.io/hostname" in selector:
            return selector["kubernetes.io/hostname"]
        for node in self.cluster.list("Node", label_selector=selector):
            return node.metadata.name
        raise AssertionError("no node matches allocation selector")

    def _call(self, node: str, claim, verb: str):
        driver = self.drivers[node]
        with grpc.insecure_channel(
                f"unix://{driver.plugin_socket}") as channel:
            stub = DRAPluginStub(channel)
            ref = dra_pb2.Claim(uid=claim.metadata.uid,
                                namespace=claim.metadata.namespace,
                                name=claim.metadata.name)
            if verb == "prepare":
                return stub.NodePrepareResources(
                    dra_pb2.NodePrepareResourcesRequest(claims=[ref]))
            return stub.NodeUnprepareResources(
                dra_pb2.NodeUnprepareResourcesRequest(claims=[ref]))

    def run_pod(self, claim: resource.ResourceClaim,
                node: str | None = None) -> PodView:
        """Schedule (if needed), prepare over gRPC, apply CDI."""
        if claim.status.allocation is None:
            scheduled = self.schedule(claim)
            node = node or scheduled
        elif node is None:
            node = self.schedule(claim)
        result = self._call(node, claim, "prepare").claims[
            claim.metadata.uid]
        if result.error:
            raise RuntimeError(result.error)
        cdi_ids: list[str] = []
        for dev in result.devices:
            for cid in dev.cdi_device_ids:
                if cid not in cdi_ids:
                    cdi_ids.append(cid)
        view = apply_cdi(Path(self.drivers[node].state.cdi.cdi_root),
                         cdi_ids)
        view.node = node
        return view

    def delete_pod(self, claim: resource.ResourceClaim, node: str) -> None:
        err = self._call(node, claim, "unprepare").claims[
            claim.metadata.uid].error
        if err:
            raise RuntimeError(err)
