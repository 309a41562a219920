"""The port's plugin binary across real process boundaries (the twin of
tests/test_oop_plugin.py): ``python -m k8s_dra_driver_tpu_torch.cmd.plugin``
runs as a subprocess against a live HTTP MiniAPIServer, claims are
prepared over its unix-socket gRPC service, and what a container would
see is held against the JAX package's binary on the same scenario.
The coordinated claim waits for the port's ``coordinatord``."""

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from oopbed import OOPBed  # noqa: E402
from torch_driver import JAX, PORT  # noqa: E402
from torch_oopbed import PortOOPBed  # noqa: E402
from torch_plugin import short_dir  # noqa: E402


def make_claim(pkg, name, cls="tpu.google.com"):
    r = pkg.resource
    return r.ResourceClaim(
        metadata=r.ObjectMeta(name=name, namespace="default",
                              uid=f"uid-{name}"),
        spec=r.ResourceClaimSpec(devices=r.DeviceClaim(
            requests=[r.DeviceRequest(name="r0", device_class_name=cls,
                                      count=1)])))


@pytest.fixture(scope="module")
def beds():
    port = PortOOPBed()
    jax_dir = short_dir("joop-")
    try:
        jax = OOPBed(jax_dir, topo={"generation": "v5e", "num_chips": 4,
                                    "root": str(jax_dir / "tree")})
    except Exception:
        port.shutdown()
        shutil.rmtree(jax_dir, ignore_errors=True)
        raise
    yield {JAX.name: jax, PORT.name: port}
    jax.shutdown()
    port.shutdown()
    shutil.rmtree(jax_dir, ignore_errors=True)


def view_of(bed, pkg, name, cls="tpu.google.com"):
    c = bed.create_claim(make_claim(pkg, name, cls))
    return c, bed.run_pod(c)


def comparable(view):
    return (view.env, view.device_nodes,
            sorted(m["containerPath"] for m in view.mounts))


class TestOutOfProcessPlugin:
    def test_slices_published_over_rest(self, beds):
        def names(bed):
            return sorted(d.name for s in bed.client.list("ResourceSlice")
                          for d in s.devices)
        port = beds[PORT.name]
        assert names(port) == names(beds[JAX.name])
        assert len(names(port)) == 13
        assert all(port.node in s.pool.name
                   for s in port.client.list("ResourceSlice"))

    @pytest.mark.parametrize("cls", ["tpu.google.com",
                                     "tpu-core.google.com"],
                             ids=["exclusive", "core"])
    def test_claim_end_to_end(self, beds, cls):
        name = "oop-ex" if cls == "tpu.google.com" else "oop-core"
        views = {}
        for pkg in (JAX, PORT):
            bed = beds[pkg.name]
            c, views[pkg.name] = view_of(bed, pkg, name, cls)
            bed.teardown_claim(c)
        vp = views[PORT.name]
        assert comparable(vp) == comparable(views[JAX.name])
        assert len(vp.visible_chips) == 1
        assert any("/dev/accel" in d for d in vp.device_nodes)
        if cls != "tpu.google.com":
            assert vp.env.get("TPU_VISIBLE_CORES")

    def test_prepare_is_idempotent_across_calls(self, beds):
        bed = beds[PORT.name]
        c = bed.create_claim(make_claim(PORT, "oop-idem"))
        v1 = bed.run_pod(c)
        v2 = bed.run_pod(c)
        assert comparable(v1) == comparable(v2)
        bed.teardown_claim(c)

    def test_unknown_claim_unprepare_is_noop(self, beds):
        beds[PORT.name].delete_pod(make_claim(PORT, "oop-ghost"))

    def test_coordinated_claim_spawns_ready_coordinator(self, beds):
        """A coordinated claim's Deployment, created over REST, becomes
        ready only when its rendered command, run by the port's
        ``coordinatord``, publishes its ready file; the daemon's files
        sit in the claim's coordination dir; teardown deletes it."""
        views = {}
        for pkg in (JAX, PORT):
            bed = beds[pkg.name]
            c = make_claim(pkg, "oop-coord")
            c.spec.devices.config = [pkg.resource.ClaimConfig(
                opaque=pkg.resource.OpaqueConfig(
                    driver="tpu.google.com", parameters={
                        "apiVersion": "tpu.google.com/v1alpha1",
                        "kind": "TpuChipConfig",
                        "sharing": {"strategy": "Coordinated",
                                    "coordinated": {
                                        "dutyCyclePercent": 50}}}))]
            c = bed.create_claim(c)
            view = views[pkg.name] = bed.run_pod(c)
            assert view.env.get("TPU_COORDINATOR_DIR") == "/coordination"
            assert view.env.get("TPU_COORDINATOR_DUTY_CYCLE_PCT") == "50"
            deps = bed.client.list("Deployment", namespace="tpu-dra-driver")
            assert deps, "no coordinator Deployment was created over REST"
            assert all(d.ready_replicas >= 1 for d in deps)
            if pkg is PORT:
                assert [k.rsplit("/", 1)[-1] for k in
                        bed.coordinator_runs] == [deps[0].metadata.name]
            (host,) = [m["hostPath"] for m in view.mounts
                       if m["containerPath"] == "/coordination"]
            schedule = json.loads((Path(host) / "schedule.json").read_text())
            assert schedule["dutyCyclePercent"] == 50
            assert (Path(host) / "ready").exists()
            bed.teardown_claim(c)
            assert not bed.client.list("Deployment",
                                       namespace="tpu-dra-driver")
        assert views[PORT.name].env == views[JAX.name].env


class TestRealProcessRestart:
    def test_checkpoint_survives_sigkill(self, beds):
        bed = beds[PORT.name]
        c, v1 = view_of(bed, PORT, "oop-crash")
        bed.restart_plugin(kill=True)
        v2 = bed.run_pod(c)
        assert comparable(v1) == comparable(v2)
        bed.teardown_claim(c)
        c2, v3 = view_of(bed, PORT, "oop-after-crash")
        assert v3.visible_chips
        bed.teardown_claim(c2)

    def test_graceful_restart_preserves_unprepare(self, beds):
        bed = beds[PORT.name]
        c, _ = view_of(bed, PORT, "oop-handoff")
        bed.restart_plugin()
        bed.teardown_claim(c)
        assert not list(bed.cdi_root.glob("*claim_uid-oop-handoff*"))


def wait_until(fn, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(0.2)
    return fn()


class TestLiveHealthLoop:
    def test_failed_chip_unpublished_live(self):
        tree = short_dir("toopt-")
        bed = PortOOPBed(topos={"oop-node": {
            "generation": "v5e", "num_chips": 4, "root": str(tree)}},
            plugin_env={"HEALTH_INTERVAL": "0.2"})
        health = tree / "sys/class/accel/accel2/device/health"
        try:
            def published():
                return {d.name for sl in bed.client.list("ResourceSlice")
                        for d in sl.devices}
            assert "chip-2" in published()
            health.write_text("hbm uncorrectable ecc\n")
            assert wait_until(lambda: "chip-2" not in published())
            assert "chip-0" in published()
            health.unlink()
            assert wait_until(lambda: "chip-2" in published())
        finally:
            bed.shutdown()
            shutil.rmtree(tree, ignore_errors=True)


class TestNvidiaNode:
    """A fake H100 node behind the binary: the published cards, and a
    claim whose container sees exactly its card by UUID."""

    def test_card_claim_over_rest_and_grpc(self):
        bed = PortOOPBed(topos={"gpu-node": {
            "generation": "h100", "num_chips": 2, "nvidia": "procfs"}})
        try:
            names = sorted(d.name for s in bed.client.list("ResourceSlice")
                           for d in s.devices)
            assert names == ["chip-4", "chip-4-core-0", "chip-6",
                             "chip-6-core-0", "slice-2x1-at-0-0-0"]
            c, view = view_of(bed, PORT, "gpu-ex")
            (res,) = c.status.allocation.results
            minor = int(res.device.removeprefix("chip-"))
            uuid = {card.minor: card.uuid
                    for card in PORT.discovery.H100_PROBE}[minor]
            assert view.env["CUDA_VISIBLE_DEVICES"] == uuid
            assert view.env["NVIDIA_VISIBLE_DEVICES"] == "void"
            assert f"/dev/nvidia{minor}" in view.device_nodes
            assert not any(k.startswith("TPU_VISIBLE") for k in view.env)
            assert [m["containerPath"] for m in view.mounts] == [
                "/usr/local/nvidia/lib64/libcuda.so.1"]
            bed.teardown_claim(c)
        finally:
            bed.shutdown()
