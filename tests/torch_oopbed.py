"""Out-of-process bed for the port's binaries (the twin of
tests/oopbed.py).

``OOPBed`` with the port's ``tpu-dra-plugin`` (``python -m
k8s_dra_driver_tpu_torch.cmd.plugin``) as the subprocess of each fake
node and, with ``with_controller=True``, the port's controller
(``python -m k8s_dra_driver_tpu_torch.cmd.controller``) as another,
against the same live HTTP ``MiniAPIServer`` through a kubeconfig.
Coordinator Deployments are run by the port's ``coordinatord``
(``torch_plugin.run_coordinator_container``).  This process plays the
scheduler with the port's allocator over the port's REST client; the
kubelet's gRPC calls and the CDI interpreter are oopbed's (the wire is
the contract).  Every path lives under a short ``/tmp`` directory: unix
socket paths stop at 107 bytes."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import threading

from k8s_dra_driver_tpu_torch.allocator import allocate_claim
from k8s_dra_driver_tpu_torch.cluster.rest import RestClusterClient
from k8s_dra_driver_tpu_torch.cmd import coordinatord

from oopbed import REPO, OOPBed
from testbed import PodView
from torch_plugin import run_coordinator_container, short_dir

PLUGIN_MODULE = "k8s_dra_driver_tpu_torch.cmd.plugin"
CONTROLLER_MODULE = "k8s_dra_driver_tpu_torch.cmd.controller"


def start_deployment_controller(server, stop: threading.Event,
                                runs: list) -> threading.Thread:
    """``tests/oopbed.py``'s kubelet stand-in for coordinator pods over
    the REST server's store, running the port's daemon: a Deployment is
    marked ready only once its rendered command has published its ready
    file (its key then joins ``runs``).  Event-driven, with a 0.5 s
    fallback wait."""
    wake = threading.Event()

    def on_write(plural, _etype, _obj):
        if plural == "deployments":
            wake.set()

    server.listeners.append(on_write)

    def loop():
        while not stop.is_set():
            wake.clear()
            todo = []
            with server._lock:
                for key, obj in server.objects.items():
                    if not key.startswith("deployments/"):
                        continue
                    replicas = obj.get("spec", {}).get("replicas", 1)
                    ready = obj.get("status", {}).get("readyReplicas", 0)
                    if ready < replicas:
                        todo.append((key, obj, replicas))
            progressed = False
            for key, obj, replicas in todo:
                pod_spec = (obj.get("spec", {}).get("template", {})
                            .get("spec", {}))
                if not run_coordinator_container(coordinatord, pod_spec):
                    continue
                runs.append(key)
                with server._lock:
                    cur = server.objects.get(key)
                    if cur is None:
                        continue
                    server._rv += 1
                    cur.setdefault("status", {})["readyReplicas"] = replicas
                    cur["metadata"]["resourceVersion"] = str(server._rv)
                server.notify("deployments", "MODIFIED", cur)
                progressed = True
            if not progressed:
                wake.wait(0.5)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


class PortOOPBed(OOPBed):
    """N fake-topology nodes, one port plugin subprocess each; ``client``
    is the port's REST client once the plugins are up."""

    def __init__(self, topos: dict[str, dict] | None = None,
                 with_controller: bool = False, **kw):
        tmp = short_dir("toop-")
        # each fake tree under the bed's directory, which shutdown removes
        topos = {name: {"root": str(tmp / name / "tree"), **topo}
                 for name, topo in (topos or {"oop-node": {
                     "generation": "v5e", "num_chips": 4}}).items()}
        # the base class would spawn the JAX controller: this bed spawns
        # the port's below
        super().__init__(tmp, topos=topos, with_controller=False, **kw)
        try:
            # swap the base class's coordinator runner (the JAX daemon)
            # for the port's before any claim is prepared
            self._stop.set()
            self._dc_thread.join(timeout=5)
            self._stop = threading.Event()
            #: Deployments the port's daemon has run, in order
            self.coordinator_runs: list[str] = []
            self._dc_thread = start_deployment_controller(
                self.api, self._stop, self.coordinator_runs)
            self.client.close()
            self.client = RestClusterClient(self.api.url, auth={}, qps=0,
                                            burst=1)
            if with_controller:
                self._spawn_controller()
        except Exception:
            self.shutdown()
            raise

    def _spawn_controller(self) -> None:
        self._ctl_log = open(self.tmp / "controller.log", "w")
        self.controller_proc = subprocess.Popen(
            [sys.executable, "-m", CONTROLLER_MODULE,
             "--kubeconfig", str(self.tmp / "kubeconfig.yaml"),
             "--kube-api-qps", "0", "--kube-api-burst", "1",
             "--device-classes", "podslice,rendezvous",
             "--retry-delay", "0.2",
             "-v", str(self.verbosity)],
            cwd=REPO, stdout=self._ctl_log, stderr=subprocess.STDOUT,
            env=dict(os.environ))

    def _spawn_plugin(self, name: str, log_file) -> subprocess.Popen:
        node_dir = self.tmp / name
        return subprocess.Popen(
            [sys.executable, "-m", PLUGIN_MODULE,
             "--node-name", name,
             "--plugin-root", str(node_dir / "plugin"),
             "--registrar-root", str(node_dir / "registrar"),
             "--cdi-root", str(node_dir / "cdi"),
             "--fake-topology", str(node_dir / "topology.json"),
             "--kubeconfig", str(self.tmp / "kubeconfig.yaml"),
             "--kube-api-qps", "0", "--kube-api-burst", "1",
             "--coordinator-namespace", "tpu-dra-driver",
             "--coordinator-image", "registry.local/tpu-dra-driver:test",
             "-v", str(self.verbosity)],
            cwd=REPO, stdout=log_file, stderr=subprocess.STDOUT,
            env={**os.environ, "NODE_NAME": name, **self.plugin_env})

    def run_pod(self, claim, node: str | None = None) -> PodView:
        """The port's allocator (scheduler role, over the port's REST
        client), then oopbed's gRPC prepare and CDI apply."""
        if claim.status.allocation is None:
            allocate_claim(self.client, claim)
        if node is None:
            selector = claim.status.allocation.node_selector or {}
            node = selector.get("kubernetes.io/hostname", self.node)
        return self.prepare_on(claim, node)

    def shutdown(self) -> None:
        super().shutdown()
        shutil.rmtree(self.tmp, ignore_errors=True)
