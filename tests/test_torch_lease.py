"""The port's card lease (the twin of the lease tests of
tests/test_gateway.py): a coordinated claim prepared through the port's
in-process bed gives the env and mounts a serving replica's
``DraChipLease`` consumes; the lease registers with the claim's port
coordinator daemon, heartbeats and unregisters on drain.  On a fake H100
host the lease names its card by GPU UUID, and a replica whose card
node vanishes drains through ``card_health_source``."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.gateway import DraChipLease as JaxLease
from k8s_dra_driver_tpu.gateway import \
    resolve_container_path as jax_resolve
from k8s_dra_driver_tpu_torch.api import resource
from k8s_dra_driver_tpu_torch.discovery import FakeHost
from k8s_dra_driver_tpu_torch.gateway import (DraChipLease, FleetGateway,
                                              ReplicaManager,
                                              card_health_source,
                                              resolve_container_path)
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.serving import Request, ServingEngine
from k8s_dra_driver_tpu_torch.plugin import DeviceState

sys.path.insert(0, str(Path(__file__).parent))

from torch_testbed import PortE2EBed  # noqa: E402

CFG = tt.TransformerConfig(dtype=torch.float32, vocab=64, d_model=32,
                           n_layers=2, n_heads=4, d_head=8, d_ff=64,
                           max_seq=48, n_kv_heads=2)


def coordinated_claim(name):
    return resource.ResourceClaim(
        metadata=resource.ObjectMeta(name=name, namespace="default"),
        spec=resource.ResourceClaimSpec(
            devices=resource.DeviceClaim(
                requests=[resource.DeviceRequest(
                    name="r0", device_class_name="tpu.google.com",
                    count=1)],
                config=[resource.ClaimConfig(
                    opaque=resource.OpaqueConfig(
                        driver="tpu.google.com", parameters={
                            "apiVersion": "tpu.google.com/v1alpha1",
                            "kind": "TpuChipConfig",
                            "sharing": {"strategy": "Coordinated",
                                        "coordinated": {
                                            "dutyCyclePercent": 50}}}))])))


@pytest.fixture
def no_sleep(monkeypatch):
    monkeypatch.setattr(DeviceState, "_sleep",
                        staticmethod(lambda s: None))


@pytest.mark.parametrize("host", [
    FakeHost(hostname="gw-host"),
    FakeHost(generation="h100", num_chips=2, hostname="gw-h100",
             nvidia="procfs")], ids=["tpu", "h100"])
def test_replica_lease_through_real_dra_prepare(host, no_sleep):
    bed = PortE2EBed([host], with_controller=False)
    try:
        claim = bed.create_claim(coordinated_claim("gw-co"))
        view = bed.run_pod(claim)
        assert view.env["TPU_COORDINATOR_DIR"] == "/coordination"
        host_dir = resolve_container_path("/coordination", view.mounts)
        assert host_dir != "/coordination"
        lease = DraChipLease(view.env, view.mounts, name="replica-a")
        if host.generation == "h100":
            assert lease.chips == [view.env["CUDA_VISIBLE_DEVICES"]]
            assert lease.chips[0].startswith("GPU-")
        else:
            assert lease.chips == view.visible_chips
            assert lease.chips == JaxLease(view.env, view.mounts).chips
        lease.acquire(wait_ready_s=5.0)
        reg = json.loads(
            (lease.client.dir / "ctl" / "replica-a.json").read_text())
        assert reg["pid"] > 0
        lease.heartbeat()           # inside the interval: no rewrite
        assert json.loads((lease.client.dir / "ctl" /
                           "replica-a.json").read_text()) == reg
        lease.release()
        assert not (lease.client.dir / "ctl" / "replica-a.json").exists()
    finally:
        bed.shutdown()


def test_lease_without_coordination_dir_is_noop():
    lease = DraChipLease({"TPU_VISIBLE_CHIPS": "2"})
    assert lease.client is None and lease.chips == [2]
    assert lease.chips == JaxLease({"TPU_VISIBLE_CHIPS": "2"}).chips
    lease.acquire()
    lease.heartbeat()
    lease.release()
    card = DraChipLease({"CUDA_VISIBLE_DEVICES": "GPU-abc"})
    assert card.client is None and card.chips == ["GPU-abc"]
    # the reference's lease reads the TPU env only: no label
    assert JaxLease({"CUDA_VISIBLE_DEVICES": "GPU-abc"}).chips == []
    assert DraChipLease({}).chips == []


def test_resolve_container_path():
    mounts = [{"hostPath": "/tmp/x/coord", "containerPath":
               "/coordination", "options": ["rw", "bind"]}]
    for path, want in (("/coordination", "/tmp/x/coord"),
                       ("/coordination/ready", "/tmp/x/coord/ready"),
                       ("/other", "/other"),
                       ("/coordinationx", "/coordinationx")):
        assert resolve_container_path(path, mounts) == want
        assert jax_resolve(path, mounts) == want
    assert resolve_container_path("/coordination", None) == "/coordination"


def test_card_replica_drains_when_its_card_goes_unhealthy(no_sleep):
    """An H100 fake tree: replicas r0 and r1 each lease a coordinated
    claim on one of the two cards; the card node of r0's claim vanishes,
    the plugin's backend reports its minor, the UUID health source maps
    it to r0's label, and the gateway drains r0 (its registration gone)
    while r1 and r0's replacement, on r1's claim, serve on."""
    host = FakeHost(generation="h100", num_chips=2, hostname="gw-h100",
                    nvidia="procfs")
    bed = PortE2EBed([host], with_controller=False)
    try:
        views = {}
        for name in ("r0", "r1"):
            views[name] = bed.run_pod(bed.create_claim(
                coordinated_claim(f"lease-{name}")))
        backend = bed.backends["gw-h100"]
        topology = backend.enumerate()
        source = card_health_source(backend.health, topology)
        assert source() == {}
        uuid_of = {c.index: c.uuid for c in topology.chips}
        gen = torch.Generator().manual_seed(0)
        params = tt.init_params(CFG, gen, device="cpu")
        mgr = ReplicaManager(
            lambda name: ServingEngine(params, CFG, slots=2, device="cpu"),
            replicas=2, health_source=source,
            # a replacement shares r1's claim
            lease_factory=lambda name: DraChipLease(
                views.get(name, views["r1"]).env,
                views.get(name, views["r1"]).mounts, name=name))
        labels = {r.name: r.chip for r in mgr.replicas}
        assert sorted(labels.values()) == sorted(uuid_of.values())
        regs = {r.name: r.lease.client.dir / "ctl" / f"{r.name}.json"
                for r in mgr.replicas}
        assert all(p.exists() for p in regs.values())
        gw = FleetGateway(mgr, queue_capacity=8)
        rng = np.random.default_rng(0)
        for i in range(4):
            gw.submit(Request(uid=f"u{i}", max_new=4, prompt=rng.integers(
                0, CFG.vocab, 6).astype(np.int32)))
        gw.step()
        minor = next(i for i, u in uuid_of.items() if u == labels["r0"])
        (bed.tmp / "hosts" / "gw-h100" / f"dev/nvidia{minor}").unlink()
        assert source() == {labels["r0"]: source()[labels["r0"]]}
        done = gw.run_until_idle()
        assert sorted(f.uid for f in done) == [f"u{i}" for i in range(4)]
        assert gw.stats()["replicas"]["dead"] == 1
        assert not regs["r0"].exists() and regs["r1"].exists()
        assert all(r.chip != labels["r0"] for r in mgr.replicas)
    finally:
        bed.shutdown()
