"""Out-of-process bed for the port's plugin binary (the twin of
tests/oopbed.py, plugins only).

``OOPBed`` with the port's ``tpu-dra-plugin`` (``python -m
k8s_dra_driver_tpu_torch.cmd.plugin``) as the subprocess of each fake
node, against the same live HTTP ``MiniAPIServer`` through a
kubeconfig.  This process plays the scheduler with the port's allocator
over the port's REST client; the kubelet's gRPC calls and the CDI
interpreter are oopbed's (the wire is the contract).  Every path lives
under a short ``/tmp`` directory: unix socket paths stop at 107 bytes.
The controller subprocess waits for the port's controller."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from k8s_dra_driver_tpu_torch.allocator import allocate_claim
from k8s_dra_driver_tpu_torch.cluster.rest import RestClusterClient

from oopbed import REPO, OOPBed
from testbed import PodView
from torch_plugin import short_dir

PLUGIN_MODULE = "k8s_dra_driver_tpu_torch.cmd.plugin"


class PortOOPBed(OOPBed):
    """N fake-topology nodes, one port plugin subprocess each; ``client``
    is the port's REST client once the plugins are up."""

    def __init__(self, topos: dict[str, dict] | None = None, **kw):
        tmp = short_dir("toop-")
        # each fake tree under the bed's directory, which shutdown removes
        topos = {name: {"root": str(tmp / name / "tree"), **topo}
                 for name, topo in (topos or {"oop-node": {
                     "generation": "v5e", "num_chips": 4}}).items()}
        super().__init__(tmp, topos=topos, **kw)
        self.client.close()
        self.client = RestClusterClient(self.api.url, auth={}, qps=0,
                                        burst=1)

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
