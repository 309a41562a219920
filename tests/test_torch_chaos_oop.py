"""Chaos across real process boundaries, through the port (the twin of
tests/test_chaos_oop.py and of tests/test_faults.py::TestDriverOutage).

Each out-of-process scenario runs the JAX package's plugin binary
(``tests/oopbed.py``'s ``OOPBed``) and the port's (``tests/torch_oopbed.py``'s
``PortOOPBed``) under the same fault plan, against a live HTTP API
server: an apiserver outage at boot, a 429 storm on the wire during a
prepare, a crash inside the checkpoint window, a torn checkpoint at
restart.  The outcomes must be equal: what was published, what each pod
saw, the injections the plan made, the exit code of the crash.  The
driver-outage scenarios run in process on both packages' beds under the
same plan: the publication queued behind backoff, the bounded retry,
the health monitor's republish; their fault logs must be equal too.
Every socket lives under a short ``/tmp`` path."""

import json
import shutil
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import grpc
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from k8s_dra_driver_tpu_torch.cluster.faults import \
    CRASH_CHECKPOINT_SAVED  # noqa: E402
from oopbed import OOPBed  # noqa: E402
from torch_acceptance import JaxE2EBed, view_record  # noqa: E402
from torch_driver import JAX, PORT  # noqa: E402
from torch_oopbed import PortOOPBed  # noqa: E402
from torch_plugin import short_dir  # noqa: E402
from torch_testbed import PortE2EBed  # noqa: E402

pytestmark = pytest.mark.faults


class JaxOOPBed(OOPBed):
    """The JAX package's bed on a short ``/tmp`` directory, which
    ``shutdown`` removes."""

    def __init__(self, **kw):
        super().__init__(short_dir("joop-"), **kw)

    def shutdown(self) -> None:
        super().shutdown()
        shutil.rmtree(self.tmp, ignore_errors=True)


def claim(pkg, name):
    r = pkg.resource
    return r.ResourceClaim(
        metadata=r.ObjectMeta(name=name, namespace="default"),
        spec=r.ResourceClaimSpec(devices=r.DeviceClaim(
            requests=[r.DeviceRequest(
                name="r0", device_class_name="tpu.google.com", count=1)])))


def both(scenario, **kw):
    """``scenario(bed, pkg)`` on the JAX binary's bed and on the port's,
    each given ``kw``, the two at once (each bed has its own API server,
    processes and directory); the outcomes must be equal.  Returns the
    port's."""
    def one(pkg):
        bed = (JaxOOPBed if pkg is JAX else PortOOPBed)(**kw)
        try:
            return scenario(bed, pkg)
        finally:
            bed.shutdown()
    with ThreadPoolExecutor(2) as pool:
        jax_out, port_out = [f.result(timeout=300) for f in
                             [pool.submit(one, pkg) for pkg in (JAX, PORT)]]
    assert port_out == jax_out
    return port_out


def chips(rec) -> list[str]:
    return [x for x in rec["env"].get("TPU_VISIBLE_CHIPS", "").split(",")
            if x]


class TestChaosOutOfProcess:
    def test_plugin_boot_survives_apiserver_outage(self):
        """The binary's first publications are dropped; it comes up and
        publishes from its bounded retry queue (the bed's readiness wait
        is the assertion), then serves a prepare end to end."""
        def scenario(bed, pkg):
            slices = [(s.node_name, sorted(d.name for d in s.devices))
                      for s in bed.client.list("ResourceSlice")]
            c = bed.create_claim(claim(pkg, "chaos-boot"))
            v = view_record(bed, bed.run_pod(c), [c])
            bed.teardown_claim(c)
            return dict(slices=slices, view=v)
        out = both(scenario, plugin_fault_plan={"rules": [
            {"verb": "*", "kind": "ResourceSlice", "times": 2,
             "error": "drop"}]})
        assert out["slices"] and chips(out["view"])

    def test_wire_level_429_storm_during_prepare(self):
        """429s with Retry-After on the real HTTP layer mid-prepare: the
        binary's claim re-fetch absorbs them and the prepare completes."""
        def scenario(bed, pkg):
            c = bed.create_claim(claim(pkg, "chaos-429"))
            pkg.allocator.allocate_claim(bed.client, c)
            bed.post_faults({"rules": [
                {"verb": "get", "kind": "ResourceClaim", "times": 2,
                 "error": "429", "retry_after_s": 0.05}]})
            v = view_record(bed, bed.run_pod(c), [c])
            log = json.loads(urllib.request.urlopen(
                bed.api.url + "/faults", timeout=5).read())["log"]
            bed.post_faults(None)
            bed.teardown_claim(c)
            return dict(view=v, injected=[e[1:4] for e in log
                                          if e[3] == "429"])
        out = both(scenario)
        assert chips(out["view"])
        assert len(out["injected"]) == 2

    def test_crash_inside_prepare_checkpoint_window(self):
        """The plugin dies right after the prepare's checkpoint save; the
        restarted process treats the claim as prepared, tears it down,
        and the chip is free again."""
        def scenario(bed, pkg):
            c = bed.create_claim(claim(pkg, "chaos-crash"))
            with pytest.raises(grpc.RpcError):
                bed.run_pod(c)
            rc = bed.plugins[bed.node].proc.wait(10)
            bed.clear_plugin_faults()
            bed.restart_plugin()
            v = view_record(bed, bed.run_pod(c), [c])
            bed.teardown_claim(c)
            c2 = bed.create_claim(claim(pkg, "chaos-after-crash"))
            v2 = view_record(bed, bed.run_pod(c2), [c2])
            bed.teardown_claim(c2)
            return dict(rc=rc, view=v, after=v2)
        # one crashpoint name in both packages' plugins
        assert CRASH_CHECKPOINT_SAVED == JAX.cluster.faults.CRASH_CHECKPOINT_SAVED
        out = both(scenario, plugin_fault_plan={"rules": [
            {"verb": CRASH_CHECKPOINT_SAVED, "skip": 1, "times": 1,
             "error": "crash"}]})
        assert out["rc"] == 86
        assert chips(out["view"]) and chips(out["after"])

    def test_torn_checkpoint_on_restart(self):
        """A half-written checkpoint.json greets the restarting plugin:
        it boots from the previous generation and re-prepares."""
        def scenario(bed, pkg):
            c = bed.create_claim(claim(pkg, "chaos-torn"))
            v1 = view_record(bed, bed.run_pod(c), [c])
            ckpt = bed.plugins[bed.node].plugin_root / "checkpoint.json"
            raw = ckpt.read_text()
            bed.plugins[bed.node].proc.kill()
            bed.plugins[bed.node].proc.wait(10)
            ckpt.write_text(raw[:len(raw) // 2])
            bed.restart_plugin()
            v2 = view_record(bed, bed.run_pod(c), [c])
            bed.teardown_claim(c)
            return dict(first=v1, again=v2)
        out = both(scenario)
        assert chips(out["again"]) == chips(out["first"])
        assert out["again"] == out["first"]


# -- the driver outage, in process ---------------------------------------

def plan_log(plan) -> list:
    """A fault plan's injections (verb, kind, name, error)."""
    return [tuple(e[:4]) for e in plan.log]


class TestDriverOutage:
    def test_apiserver_outage_at_boot_queues_publication(self):
        """The apiserver is down when the plugin boots: the gRPC sockets
        come up anyway, publication waits behind backoff and lands once
        the outage ends."""
        outs = []
        for pkg in (JAX, PORT):
            plan = pkg.cluster.FaultPlan([pkg.cluster.FaultRule(
                verb="*", kind="ResourceSlice", times=5, error="drop")])
            hosts = [pkg.discovery.FakeHost()]
            bed = (JaxE2EBed if pkg is JAX else PortE2EBed)(
                hosts, with_controller=False, fault_plan=plan)
            try:
                driver = bed.drivers["tpu-host-0"]
                socket = driver.plugin_socket.exists()
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    if bed.cluster.list("ResourceSlice") \
                            and not driver.publish_pending:
                        break
                    time.sleep(0.02)
                outs.append(dict(
                    socket=socket, pending=driver.publish_pending,
                    slices=sorted(d.name for s in bed.cluster.list(
                        "ResourceSlice") for d in s.devices),
                    log=plan_log(plan)))
            finally:
                bed.shutdown()
        assert outs[1] == outs[0]
        out = outs[1]
        assert out["socket"] and out["slices"] and not out["pending"]
        assert [e[3] for e in out["log"]].count("drop") == 5

    @staticmethod
    def dead_driver(pkg, root: Path, backoff):
        """A driver whose every API call is dropped."""
        plan = pkg.cluster.FaultPlan([pkg.cluster.FaultRule(
            times=-1, error="drop")])
        backend = pkg.discovery.FakeHost().materialize(root / "host")
        cluster = pkg.cluster.FakeCluster()
        faulty = pkg.cluster.FaultyClusterClient(cluster, plan,
                                                 sleep=lambda s: None)
        state = pkg.plugin.DeviceState(
            backend, faulty, pkg.plugin.DeviceStateConfig(
                plugin_root=str(root / "plugin"), cdi_root=str(root / "cdi"),
                node_name="tpu-host-0"))
        driver = pkg.plugin.Driver(state, faulty,
                                   plugin_dir=str(root / "plugin"),
                                   publish_backoff=backoff)
        return plan, backend, cluster, driver

    def test_publish_retry_is_bounded(self):
        """A permanently dead apiserver: the bounded backoff gives up and
        leaves the publication pending for the health monitor."""
        steps = 3
        outs = []
        for pkg in (JAX, PORT):
            root = short_dir("tout-")
            plan, _, _, driver = self.dead_driver(
                pkg, root, pkg.backoff.Backoff(
                    duration_s=0.01, jitter=0, steps=steps, cap_s=0.01,
                    deadline_s=5.0))
            driver.start()
            try:
                driver._publish_thread.join(timeout=10)
                outs.append(dict(
                    alive=driver._publish_thread.is_alive(),
                    pending=driver.publish_pending,
                    lists=len([e for e in plan.log if e[0] == "list"])))
            finally:
                driver.shutdown()
                shutil.rmtree(root, ignore_errors=True)
        assert outs[1] == outs[0]
        assert outs[1] == dict(alive=False, pending=True, lists=steps + 2)

    def test_health_monitor_picks_up_pending_publication(self):
        """After the bounded boot retry gives up, the periodic health
        monitor republishes once the outage ends."""
        outs = []
        for pkg in (JAX, PORT):
            root = short_dir("tout-")
            plan, backend, cluster, driver = self.dead_driver(
                pkg, root, pkg.backoff.Backoff(
                    duration_s=0.001, jitter=0, steps=1, cap_s=0.001,
                    deadline_s=5.0))
            driver.start()
            try:
                driver._publish_thread.join(timeout=10)
                pending = driver.publish_pending
                plan.rules[0].times = 0
                monitor = pkg.health.HealthMonitor(driver, backend,
                                                   interval=0)
                outs.append(dict(
                    pending=pending, republished=monitor.check_once(),
                    after=driver.publish_pending,
                    slices=sorted(d.name for s in cluster.list(
                        "ResourceSlice") for d in s.devices)))
            finally:
                driver.shutdown()
                shutil.rmtree(root, ignore_errors=True)
        assert outs[1] == outs[0]
        out = outs[1]
        assert out["pending"] and out["republished"] and not out["after"]
        assert out["slices"]
