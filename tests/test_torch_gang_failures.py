"""Gang failure semantics over the port (the twin of
tests/test_gang_failures.py), on the in-process port bed against the
4-host 4x4 pod-slice gang:

1. plugin restart mid-gang-prepare: the restarted worker rejoins with
   identical rendezvous identity,
2. one worker unprepares while the rest hold the claim: rejoin
   reproduces the same world; other workers unaffected,
3. controller restart with active slices: gang pools are re-published
   identically and existing allocations stay consistent;

and the gang pool the port publishes equals the JAX bed's, both on short
socket paths."""

import shutil
import sys
from pathlib import Path

import pytest

from k8s_dra_driver_tpu.discovery import fake_slice_hosts as jax_slice_hosts
from k8s_dra_driver_tpu_torch.allocator import AllocationError, allocate_claim
from k8s_dra_driver_tpu_torch.api import resource
from k8s_dra_driver_tpu_torch.api.config.v1alpha1 import API_VERSION
from k8s_dra_driver_tpu_torch.discovery import fake_slice_hosts

sys.path.insert(0, str(Path(__file__).parent))

from testbed import E2EBed  # noqa: E402
from torch_driver import as_dict  # noqa: E402
from torch_plugin import short_dir  # noqa: E402
from torch_testbed import PortE2EBed  # noqa: E402


@pytest.fixture
def gang():
    bed = PortE2EBed(fake_slice_hosts(4, topology="4x4"))
    yield bed
    bed.shutdown()


def claim(name, requests, configs=()):
    return resource.ResourceClaim(
        metadata=resource.ObjectMeta(name=name, namespace="default"),
        spec=resource.ResourceClaimSpec(devices=resource.DeviceClaim(
            requests=requests, config=list(configs))))


def rdv_claim(name="gang-channel"):
    return claim(
        name,
        [resource.DeviceRequest(name="chan",
                                device_class_name="tpu-rendezvous.google.com")],
        [resource.ClaimConfig(opaque=resource.OpaqueConfig(
            driver="tpu.google.com",
            parameters={"apiVersion": API_VERSION,
                        "kind": "RendezvousConfig"}))])


def rdv_env(bed, shared, worker):
    view = bed.run_pod(shared, node=f"slice-a-w{worker}")
    return dict(view.env)


class TestPluginRestartMidGangPrepare:
    def test_restarted_worker_rejoins_identically(self, gang):
        bed = gang
        shared = bed.create_claim(rdv_claim())
        allocate_claim(bed.cluster, shared)
        env0 = rdv_env(bed, shared, 0)
        env1 = rdv_env(bed, shared, 1)
        bed.restart_driver("slice-a-w1")
        env1b = rdv_env(bed, shared, 1)
        assert env1b == env1
        env2 = rdv_env(bed, shared, 2)
        env3 = rdv_env(bed, shared, 3)
        envs = [env0, env1b, env2, env3]
        assert len({e["TPU_RENDEZVOUS_CHANNEL"] for e in envs}) == 1
        assert len({e["TPU_COORDINATOR_ADDRESS"] for e in envs}) == 1
        assert {e["TPU_WORKER_ID"] for e in envs} == {"0", "1", "2", "3"}

    def test_restart_preserves_prepared_set_across_gang(self, gang):
        bed = gang
        shared = bed.create_claim(rdv_claim())
        allocate_claim(bed.cluster, shared)
        for w in range(4):
            rdv_env(bed, shared, w)
        before = set(bed.drivers["slice-a-w2"].state.prepared)
        bed.restart_driver("slice-a-w2")
        assert set(bed.drivers["slice-a-w2"].state.prepared) == before


class TestLoneUnprepare:
    def test_one_worker_unprepare_then_rejoin(self, gang):
        bed = gang
        shared = bed.create_claim(rdv_claim())
        allocate_claim(bed.cluster, shared)
        envs = [rdv_env(bed, shared, w) for w in range(4)]
        bed.delete_pod(shared, "slice-a-w3")
        assert shared.metadata.uid not in \
            bed.drivers["slice-a-w3"].state.prepared
        for w in range(3):
            assert shared.metadata.uid in \
                bed.drivers[f"slice-a-w{w}"].state.prepared
        env3b = rdv_env(bed, shared, 3)
        assert env3b == envs[3]

    def test_unprepare_is_idempotent_on_nonholder(self, gang):
        bed = gang
        shared = bed.create_claim(rdv_claim())
        allocate_claim(bed.cluster, shared)
        rdv_env(bed, shared, 0)
        bed.delete_pod(shared, "slice-a-w2")
        assert shared.metadata.uid in \
            bed.drivers["slice-a-w0"].state.prepared


def gang_slices(bed):
    return sorted((s for s in bed.cluster.list("ResourceSlice")
                   if s.node_selector), key=lambda s: s.metadata.name)


def signature(slices):
    return [(s.pool.name, s.node_selector,
             sorted(d.name for d in s.devices)) for s in slices]


class TestControllerRestartWithActiveSlices:
    def test_gang_pool_republished_identically(self, gang):
        bed = gang
        before = gang_slices(bed)
        assert before, "controller never published the gang pool"
        bed.restart_controller()
        after = gang_slices(bed)
        assert signature(after) == signature(before)
        assert len({s.pool.name for s in after}) == len(after)

    def test_active_allocation_survives_restart(self, gang):
        bed = gang
        g = bed.create_claim(claim(
            "whole-slice",
            [resource.DeviceRequest(
                name="tpu", device_class_name="tpu-podslice.google.com")]))
        allocate_claim(bed.cluster, g)
        res = g.status.allocation.results[0]
        bed.restart_controller()
        devices = {(s.pool.name, d.name)
                   for s in gang_slices(bed) for d in s.devices}
        assert (res.pool, res.device) in devices
        g2 = bed.create_claim(claim(
            "whole-slice-2",
            [resource.DeviceRequest(
                name="tpu", device_class_name="tpu-podslice.google.com")]))
        with pytest.raises(AllocationError):
            allocate_claim(bed.cluster, g2)

    def test_shared_claim_preparable_after_controller_restart(self, gang):
        bed = gang
        shared = bed.create_claim(rdv_claim())
        allocate_claim(bed.cluster, shared)
        env0 = rdv_env(bed, shared, 0)
        bed.restart_controller()
        env1 = rdv_env(bed, shared, 1)
        assert env1["TPU_RENDEZVOUS_CHANNEL"] == \
            env0["TPU_RENDEZVOUS_CHANNEL"]
        assert env1["TPU_COORDINATOR_ADDRESS"] == \
            env0["TPU_COORDINATOR_ADDRESS"]


def test_gang_pool_equals_the_jax_beds(gang):
    """The JAX bed over the same four hosts, on a short path of its own:
    the controllers' gang pools are equal, device for device."""
    tmp = short_dir("je2e-")
    jax_bed = E2EBed(tmp, jax_slice_hosts(4, topology="4x4"))
    try:
        def pools(slices):
            out = []
            for s in slices:
                d = as_dict(s)
                for key in ("uid", "resource_version", "creation_timestamp",
                            "name"):
                    d["metadata"].pop(key, None)
                out.append(d)
            return out
        port = pools(gang_slices(gang))
        assert port and port == pools(gang_slices(jax_bed))
    finally:
        jax_bed.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
