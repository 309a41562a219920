"""Concurrency stress over the port (the twin of tests/test_concurrency.py),
on ``PortE2EBed``: the real gRPC surface hammered from many threads
while the slice controller processes node churn.  Each scenario runs on
the JAX package's bed too, over the same fake hosts, and the outcomes
that do not depend on thread timing must be equal: no error, no lost or
duplicated prepare, the prepared set and the checkpoint drained, one
CDI answer to 24 racing prepares of one claim, the gang pools left by
the churn, the prepared set a restart restores.  One more case cycles
claims of a four-card H100 node, each spec naming its own card."""

import importlib
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import grpc
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_acceptance import normalizer, run_both, view_record  # noqa: E402
from torch_driver import JAX, PORT  # noqa: E402
from torch_testbed import PortE2EBed  # noqa: E402


@pytest.fixture(autouse=True)
def no_sleep(monkeypatch):
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.plugin.DeviceState, "_sleep",
                            staticmethod(lambda s: None))


def claim(pkg, name, cls="tpu.google.com"):
    r = pkg.resource
    return r.ResourceClaim(
        metadata=r.ObjectMeta(name=name, namespace="default"),
        spec=r.ResourceClaimSpec(devices=r.DeviceClaim(
            requests=[r.DeviceRequest(name="tpu", device_class_name=cls,
                                      count=1)])))


def both(scenario):
    """``scenario(bed, pkg)`` on each package's bed over one v5e host
    ``h0``, no controller; the outcomes must be equal.  Returns the
    port's."""
    return run_both(lambda pkg: [pkg.discovery.FakeHost(hostname="h0")],
                    scenario, with_controller=False)


def ref(pkg, c):
    return pkg.proto.dra_pb2.Claim(uid=c.metadata.uid, namespace="default",
                                   name=c.metadata.name)


def cycles(bed, pkg, claims, rounds=25, threads=16, per_claim=4):
    """``per_claim`` threads a claim, each ``rounds`` prepare/unprepare
    cycles over one shared channel; the errors, in no order."""
    pb = pkg.proto.dra_pb2
    with grpc.insecure_channel(
            f"unix://{bed.drivers['h0'].plugin_socket}") as channel:
        stub = pkg.proto.DRAPluginStub(channel)
        errors = []

        def cycle(c):
            for _ in range(rounds):
                r = stub.NodePrepareResources(pb.NodePrepareResourcesRequest(
                    claims=[ref(pkg, c)])).claims[c.metadata.uid]
                if r.error:
                    errors.append(r.error)
                    return
                r = stub.NodeUnprepareResources(
                    pb.NodeUnprepareResourcesRequest(
                        claims=[ref(pkg, c)])).claims[c.metadata.uid]
                if r.error:
                    errors.append(r.error)
                    return

        with ThreadPoolExecutor(threads) as pool:
            futs = [pool.submit(cycle, c) for c in claims
                    for _ in range(per_claim)]
            for f in futs:
                f.result(timeout=120)
    return sorted(errors)


class TestConcurrentPrepare:
    def test_parallel_prepare_unprepare_cycles(self):
        """16 threads x prepare/unprepare cycles on one node: no error,
        the state and the checkpoint drain to empty."""
        def scenario(bed, pkg):
            claims = []
            for i in range(4):
                c = bed.create_claim(claim(pkg, f"c{i}"))
                bed.schedule(c)
                claims.append(c)
            errors = cycles(bed, pkg, claims)
            state = bed.drivers["h0"].state
            return dict(errors=errors, prepared=dict(state.prepared),
                        checkpoint=state.checkpoints.load(),
                        devices=sorted(c.status.allocation.results[0].device
                                       for c in claims))
        out = both(scenario)
        assert out["errors"] == [] and out["prepared"] == {}
        assert out["checkpoint"] == {}
        assert out["devices"] == [f"chip-{i}" for i in range(4)]

    def test_idempotent_concurrent_prepare_same_claim(self):
        """24 racing prepares of one claim from 12 threads: one answer,
        one prepared claim."""
        def scenario(bed, pkg):
            c = bed.create_claim(claim(pkg, "shared"))
            bed.schedule(c)
            pb = pkg.proto.dra_pb2
            results = []
            with grpc.insecure_channel(
                    f"unix://{bed.drivers['h0'].plugin_socket}") as channel:
                stub = pkg.proto.DRAPluginStub(channel)

                def prep():
                    r = stub.NodePrepareResources(
                        pb.NodePrepareResourcesRequest(
                            claims=[ref(pkg, c)])).claims[c.metadata.uid]
                    assert not r.error, r.error
                    results.append(tuple(sorted(
                        cid for d in r.devices for cid in d.cdi_device_ids)))

                with ThreadPoolExecutor(12) as pool:
                    for f in [pool.submit(prep) for _ in range(24)]:
                        f.result(timeout=60)
            norm = normalizer(bed, [c])
            return dict(answers=sorted({tuple(norm(x) for x in r)
                                        for r in results}),
                        calls=len(results),
                        prepared=[norm(u) for u in
                                  bed.drivers["h0"].state.prepared])
        out = both(scenario)
        assert len(out["answers"]) == 1 and out["calls"] == 24
        assert out["prepared"] == ["<uid:default/shared>"]

    def test_h100_cycles_then_each_spec_names_its_card(self):
        """A four-card H100 node: 16 threads cycle the four claims and
        everything drains; then each claim's spec names its own card by
        UUID."""
        bed = PortE2EBed([PORT.discovery.FakeHost(
            generation="h100", num_chips=4, hostname="h0")],
            with_controller=False)
        try:
            claims = [bed.create_claim(claim(PORT, f"g{i}"))
                      for i in range(4)]
            for c in claims:
                bed.schedule(c)
            uuids = {c.minor: c.uuid for c in bed.hosts["h0"].nvidia_cards()}
            want = {c.metadata.uid: uuids[int(c.status.allocation.results[0]
                                              .device.removeprefix("chip-"))]
                    for c in claims}
            assert sorted(want.values()) == sorted(uuids.values())
            state = bed.drivers["h0"].state
            assert cycles(bed, PORT, claims, rounds=10) == []
            assert state.prepared == {} and state.checkpoints.load() == {}
            for c in claims:
                v = bed.run_pod(c)
                assert v.env["CUDA_VISIBLE_DEVICES"] == want[c.metadata.uid]
            specs = {}
            for p in Path(state.cdi.cdi_root).glob("*claim_*.json"):
                (dev,) = json.loads(p.read_text())["devices"]
                specs[dev["name"]] = [e for e in dev["containerEdits"]["env"]
                                      if e.startswith("CUDA_VISIBLE_DEVICES=")]
            assert specs == {uid: [f"CUDA_VISIBLE_DEVICES={u}"]
                             for uid, u in want.items()}
        finally:
            bed.shutdown()


class TestControllerChurn:
    def test_node_label_churn(self):
        """Nodes joining and leaving slices from four threads: the
        published pools converge to the survivors; stop removes them."""
        def scenario(pkg):
            top = importlib.import_module(pkg.name)
            ctl_mod = importlib.import_module(f"{pkg.name}.controller")
            cluster = pkg.cluster.FakeCluster()
            ctrl = ctl_mod.SliceGangController(cluster, retry_delay_s=0.01)
            ctrl.start()
            try:
                def churn(slice_idx):
                    value = f"slice-{slice_idx}.4x4"
                    for round_ in range(10):
                        nodes = []
                        for w in range(4):
                            n = pkg.cluster.Node(
                                metadata=pkg.resource.ObjectMeta(
                                    name=f"s{slice_idx}-w{w}-r{round_}",
                                    labels={top.SLICE_LABEL: value}))
                            cluster.create(n)
                            nodes.append(n)
                        for n in nodes[:-1]:
                            cluster.delete("Node", "", n.metadata.name)

                with ThreadPoolExecutor(4) as pool:
                    for f in [pool.submit(churn, i) for i in range(4)]:
                        f.result(timeout=120)
                pools = sorted({s.pool.name
                                for s in cluster.list("ResourceSlice")})
            finally:
                ctrl.stop()
            return dict(pools=pools, left=cluster.list("ResourceSlice"))
        jax_out, port_out = scenario(JAX), scenario(PORT)
        assert port_out == jax_out
        assert len(port_out["pools"]) == 4 and port_out["left"] == []


class TestRestartUnderLoad:
    def test_restart_mid_traffic_resumes_prepared(self):
        """A plugin restart with claims prepared: a fresh DeviceState
        over the same plugin dir restores exactly the prepared set, and
        re-prepares through a fresh driver give the same views."""
        def scenario(bed, pkg):
            driver = bed.drivers["h0"]
            claims, views = [], []
            for i in range(3):
                c = bed.create_claim(claim(pkg, f"r{i}"))
                views.append(view_record(bed, bed.run_pod(c), [c]))
                claims.append(c)
            before = set(driver.state.prepared)
            driver.shutdown()
            backend = bed.hosts["h0"].materialize(bed.tmp / "hosts" / "h0")
            state2 = pkg.plugin.DeviceState(
                backend, bed.cluster, pkg.plugin.DeviceStateConfig(
                    plugin_root=str(bed.tmp / "plugin" / "h0"),
                    cdi_root=str(bed.tmp / "cdi" / "h0"), node_name="h0",
                    coordinator_image="registry.local/tpu-dra-driver:test"))
            restored = set(state2.prepared)
            driver2 = pkg.plugin.Driver(
                state2, bed.cluster,
                plugin_dir=str(bed.tmp / "plugin" / "h0"))
            driver2.start()
            bed.drivers["h0"] = driver2
            again = [view_record(bed, bed.run_pod(c, node="h0"), [c])
                     for c in claims]
            norm = normalizer(bed, claims)
            return dict(restored=sorted(norm(u) for u in restored),
                        same=restored == before, views=views, again=again)
        out = both(scenario)
        assert out["same"] and len(out["restored"]) == 3
        assert out["again"] == out["views"]
        assert all(v["env"]["TPU_VISIBLE_CHIPS"] for v in out["again"])
