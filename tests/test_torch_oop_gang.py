"""Multi-host gang over real processes, the port's binaries (the twin of
tests/test_oop_gang.py): 4 port plugin binaries and the port's
controller binary against one live HTTP API server.  Plugins self-label
their Nodes over the wire, the port's controller publishes the
slice-scoped gang pool, prepares flow over four UDS gRPC sockets, and
four workers consume the rendezvous env with the port's
``parallel/rendezvous.py`` (gloo) in a real cross-process all-reduce."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from k8s_dra_driver_tpu_torch.allocator import allocate_claim
from k8s_dra_driver_tpu_torch.api import resource
from k8s_dra_driver_tpu_torch.api.config.v1alpha1 import API_VERSION

sys.path.insert(0, str(Path(__file__).parent))

from torch_oopbed import PortOOPBed  # noqa: E402

REPO = Path(__file__).parent.parent

N_HOSTS = 4


def slice_topos(num_hosts=N_HOSTS, slice_id="slice-a", topology="4x4"):
    names = [f"{slice_id}-w{i}" for i in range(num_hosts)]
    return {
        name: {
            "generation": "v5e", "num_chips": 4, "host_bounds": "2,2,1",
            "slice_id": slice_id, "topology": topology, "worker_id": i,
            "worker_hostnames": names,
        }
        for i, name in enumerate(names)
    }


def claim(name, requests, configs=()):
    return resource.ResourceClaim(
        metadata=resource.ObjectMeta(name=name, namespace="default"),
        spec=resource.ResourceClaimSpec(devices=resource.DeviceClaim(
            requests=requests,
            config=[resource.ClaimConfig(opaque=resource.OpaqueConfig(
                driver="tpu.google.com", parameters=p))
                for p in configs])))


def req(name="r0", cls="tpu.google.com", selectors=()):
    return resource.DeviceRequest(
        name=name, device_class_name=cls, count=1,
        selectors=[resource.DeviceSelector(cel=s) for s in selectors])


@pytest.fixture(scope="module")
def bed():
    b = PortOOPBed(topos=slice_topos(), with_controller=True)
    yield b
    b.shutdown()


class TestOutOfProcessGang:
    def test_nodes_self_labeled_over_rest(self, bed):
        for name in bed.plugins:
            node = bed.client.get("Node", "", name)
            assert node.metadata.labels.get("tpu.google.com/slice") == \
                "slice-a.4x4", name

    def test_controller_publishes_gang_pool(self, bed):
        gang = bed.await_gang_pool()
        assert "k8s_dra_driver_tpu_torch.cmd.controller" in \
            bed.controller_proc.args
        devices = [d for s in gang for d in s.devices]
        kinds = {d.attributes.get("type") for d in devices}
        assert "podslice" in kinds
        assert "rendezvous" in kinds
        assert all(s.node_selector == {"tpu.google.com/slice":
                                       "slice-a.4x4"} for s in gang)

    def test_gang_workers_see_consistent_world(self, bed):
        bed.await_gang_pool()
        shared = bed.create_claim(claim(
            "oop-gang-channel",
            [req("chan", cls="tpu-rendezvous.google.com")],
            configs=[{"apiVersion": API_VERSION,
                      "kind": "RendezvousConfig"}]))
        allocate_claim(bed.client, shared)

        views = []
        for w in range(N_HOSTS):
            node = f"slice-a-w{w}"
            local = bed.create_claim(claim(
                f"oop-w{w}-chips", [req(
                    cls="tpu-slice.google.com",
                    selectors=['device.attributes["sliceShape"]'
                               ' == "2x2"'])]))
            chip_view = bed.run_pod(local)
            assert chip_view.node == node
            rdv_view = bed.prepare_on(shared, node)
            env = dict(chip_view.env)
            env.update(rdv_view.env)
            views.append(env)

        assert {v["TPU_TOPOLOGY"] for v in views} == {"4x4"}
        assert len({v["TPU_COORDINATOR_ADDRESS"] for v in views}) == 1
        assert {v["TPU_WORKER_ID"] for v in views} == {"0", "1", "2", "3"}
        assert len({v["TPU_RENDEZVOUS_CHANNEL"] for v in views}) == 1
        assert {v["TPU_SLICE_ID"] for v in views} == {"slice-a"}

        for w in range(N_HOSTS):
            bed.delete_pod(shared, f"slice-a-w{w}")

    def test_rendezvous_env_drives_real_cross_process_collective(
            self, bed):
        """Four real worker processes read the env a real gang prepare
        injected and stand up a gloo process group and an all-reduce
        across processes; each contributes rank+1 and all four must see
        the same global sum."""
        bed.await_gang_pool()
        free = socket.socket()
        free.bind(("127.0.0.1", 0))
        port = free.getsockname()[1]
        free.close()
        shared = bed.create_claim(claim(
            "oop-rdv-consume",
            [req("chan", cls="tpu-rendezvous.google.com")],
            configs=[{"apiVersion": API_VERSION,
                      "kind": "RendezvousConfig", "port": port}]))
        allocate_claim(bed.client, shared)

        workers = []
        for w in range(N_HOSTS):
            node = f"slice-a-w{w}"
            rdv_view = bed.prepare_on(shared, node)
            env = dict(os.environ, OMP_NUM_THREADS="1")
            env.update(rdv_view.env)
            assert env["TPU_COORDINATOR_ADDRESS"].endswith(f":{port}")
            assert env["TPU_NUM_WORKERS"] == str(N_HOSTS)
            workers.append(subprocess.Popen(
                [sys.executable, "-m",
                 "k8s_dra_driver_tpu_torch.parallel.rendezvous",
                 "--host-override", "127.0.0.1", "--backend", "gloo"],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        try:
            reports = []
            for p in workers:
                out, err = p.communicate(timeout=180)
                assert p.returncode == 0, err[-2000:]
                reports.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for p in workers:
                if p.poll() is None:
                    p.kill()
            for w in range(N_HOSTS):
                bed.delete_pod(shared, f"slice-a-w{w}")

        expected = float(sum(range(1, N_HOSTS + 1)))
        assert {r["worker_id"] for r in reports} == set(range(N_HOSTS))
        assert all(r["psum"] == expected for r in reports), reports
        assert all(r["world_size"] == N_HOSTS for r in reports), reports
