"""End-to-end acceptance through the port (the twin of tests/test_e2e.py):
BASELINE.md's five target configurations driven through discovery,
publication, allocation, gRPC prepare and CDI injection.

Each scenario runs on the JAX package's ``E2EBed`` and on the port's
``PortE2EBed`` over the same fake TPU hosts; every pod's view (env,
device nodes, mounts), every claim's allocated devices and every
refusal must be equal field by field, and the JAX test's assertions
hold for the port's run.  Then the configurations run on fake H100
hosts (``FakeHost(generation="h100")``) through the port alone:
``CUDA_VISIBLE_DEVICES`` lists the claimed cards' UUIDs in minor order,
``/dev/nvidia<minor>`` their device nodes.  Both packages' beds keep
their sockets under short ``/tmp`` paths."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from helpers import chip_config  # noqa: E402
from torch_acceptance import (allocated, chips, deployments,  # noqa: E402
                              run_both, view_record)
from torch_driver import JAX, PORT  # noqa: E402
from torch_testbed import PortE2EBed  # noqa: E402


@pytest.fixture(autouse=True)
def no_sleep(monkeypatch):
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.plugin.DeviceState, "_sleep",
                            staticmethod(lambda s: None))


def claim(pkg, name, requests, configs=()):
    r = pkg.resource
    return r.ResourceClaim(
        metadata=r.ObjectMeta(name=name, namespace="default"),
        spec=r.ResourceClaimSpec(devices=r.DeviceClaim(
            requests=requests, config=list(configs))))


def req(pkg, name="tpu", count=1, cls="tpu.google.com", selectors=()):
    r = pkg.resource
    return r.DeviceRequest(
        name=name, device_class_name=cls, count=count,
        selectors=[r.DeviceSelector(cel=s) for s in selectors])


def cfg(pkg, params):
    r = pkg.resource
    return r.ClaimConfig(opaque=r.OpaqueConfig(driver="tpu.google.com",
                                               parameters=params))


class Run:
    """One scenario's observations on one bed: records of the pods'
    views, the claims' allocations and the allocator's refusals, in
    order."""

    def __init__(self, bed, pkg):
        self.bed, self.pkg = bed, pkg
        self.claims, self.log = [], []

    def create(self, c):
        c = self.bed.create_claim(c)
        self.claims.append(c)
        return c

    def pod(self, c, node=None) -> dict:
        rec = view_record(self.bed, self.bed.run_pod(c, node=node),
                          self.claims)
        self.log.append(("pod", c.metadata.name, rec))
        return rec

    def allocate(self, c) -> str | None:
        """The allocator on ``c``: None, or its refusal's message."""
        try:
            self.pkg.allocator.allocate_claim(self.bed.cluster, c)
        except self.pkg.allocator.AllocationError as e:
            self.log.append(("refused", c.metadata.name, str(e)))
            return str(e)
        self.log.append(("allocated", c.metadata.name, allocated(c)))
        return None

    def record(self) -> dict:
        return dict(log=self.log, claims=[(c.metadata.name, allocated(c))
                                          for c in self.claims],
                    deployments=deployments(self.bed, self.claims))


def both(hosts, scenario):
    """``scenario(run)`` on the JAX bed and on the port's, each over
    ``hosts(pkg)``; the records must be equal.  Returns the port's."""
    def record(bed, pkg):
        run = Run(bed, pkg)
        scenario(run)
        return run.record()
    return run_both(hosts, record)


def single_host(pkg):
    return [pkg.discovery.FakeHost(hostname="tpu-host-0")]


def v5p_host(pkg):
    return [pkg.discovery.FakeHost(generation="v5p", hostname="p0")]


def gang_hosts(pkg):
    return pkg.discovery.fake_slice_hosts(4, topology="4x4")


def pods(out) -> list[dict]:
    return [rec for kind, _, rec in out["log"] if kind == "pod"]


def refusals(out) -> list[str]:
    return [name for kind, name, _ in out["log"] if kind == "refused"]


def slice_req(pkg, shape="2x2"):
    return req(pkg, cls="tpu-slice.google.com",
               selectors=[f'device.attributes["sliceShape"] == "{shape}"'])


class TestTpuTest1DedicatedChips:
    def test_two_pods_get_distinct_chips(self):
        def scenario(run):
            c1 = run.create(claim(run.pkg, "pod1-tpu", [req(run.pkg)]))
            c2 = run.create(claim(run.pkg, "pod2-tpu", [req(run.pkg)]))
            run.pod(c1)
            run.pod(c2)
        v1, v2 = pods(both(single_host, scenario))
        assert chips(v1) and chips(v2)
        assert set(chips(v1)).isdisjoint(chips(v2))
        assert v1["device_nodes"] != v2["device_nodes"]
        assert v1["env"]["TPU_SKIP_MDS_QUERY"] == "true"
        assert any(m["containerPath"] == "/usr/lib/libtpu.so"
                   for m in v1["mounts"])


class TestTpuTest23SharedChip:
    def test_timeslice_shared_claim(self):
        def scenario(run):
            shared = run.create(claim(run.pkg, "shared-tpu", [req(run.pkg)], [
                cfg(run.pkg, chip_config("TimeSlicing",
                                         timeSlicing={"interval": "Long"}))]))
            run.pod(shared)
            run.pod(shared)
        v1, v2 = pods(both(single_host, scenario))
        assert chips(v1) == chips(v2)
        assert v1["env"]["TPU_RUNTIME_PREEMPTION_MS"] == "20"

    def test_coordinated_shared_claim(self):
        def scenario(run):
            shared = run.create(claim(run.pkg, "shared-tpu", [req(run.pkg)], [
                cfg(run.pkg, chip_config(
                    "Coordinated", coordinated={"dutyCyclePercent": 50}))]))
            run.pod(shared)
        out = both(single_host, scenario)
        (v,) = pods(out)
        assert v["env"]["TPU_COORDINATOR_DUTY_CYCLE_PCT"] == "50"
        assert any(m["containerPath"] == "/coordination"
                   for m in v["mounts"])
        assert len(out["deployments"]) == 1


class TestSingleCorePartition:
    def test_core_partition_env(self):
        def scenario(run):
            p = run.pkg
            c = run.create(claim(p, "core-claim",
                                 [req(p, cls="tpu-core.google.com")]))
            v = run.pod(c)
            chip = v["env"]["TPU_VISIBLE_CORES"].split(":")[0]
            run.pod(run.create(claim(p, "sibling", [req(
                p, cls="tpu-core.google.com",
                selectors=[f'device.attributes["index"] == {chip}'])])))
            run.allocate(run.create(claim(p, "whole", [req(
                p, selectors=[f'device.attributes["index"] == {chip}'])])))
        out = both(v5p_host, scenario)
        v, sibling = pods(out)
        chip, _ = v["env"]["TPU_VISIBLE_CORES"].split(":")
        assert chips(v) == [int(chip)] == chips(sibling)
        assert refusals(out) == ["whole"]


class TestIciContiguousSlice:
    def test_slice_is_contiguous_and_exclusive(self):
        def scenario(run):
            run.pod(run.create(claim(run.pkg, "slice-claim",
                                     [slice_req(run.pkg)])))
            run.allocate(run.create(claim(run.pkg, "leftover",
                                          [req(run.pkg)])))
        out = both(single_host, scenario)
        (v,) = pods(out)
        assert chips(v) == [0, 1, 2, 3]
        assert sorted(v["device_nodes"]) == [f"/dev/accel{i}"
                                             for i in range(4)]
        assert refusals(out) == ["leftover"]

    def test_unprepare_frees_chips(self):
        def scenario(run):
            c = run.create(claim(run.pkg, "slice-claim",
                                 [slice_req(run.pkg)]))
            v = run.pod(c)
            run.bed.delete_pod(c, v["node"])
            run.bed.cluster.delete("ResourceClaim", "default", "slice-claim")
            run.claims.remove(c)
            run.pod(run.create(claim(run.pkg, "after", [req(run.pkg)])))
        out = both(single_host, scenario)
        assert len(pods(out)) == 2 and not refusals(out)


class TestMultiHostGang:
    def test_controller_published_gang_pool(self):
        def scenario(run):
            slices = [s for s in run.bed.cluster.list("ResourceSlice")
                      if s.node_selector]
            run.log.append(("pool", "", [
                (s.pool.name, dict(s.node_selector),
                 sorted((d.name, sorted(d.attributes.items()))
                        for d in s.devices)) for s in slices]))
        out = both(gang_hosts, scenario)
        ((_, _, pools),) = out["log"]
        ((_, selector, devices),) = pools
        assert selector == {"tpu.google.com/slice": "slice-a.4x4"}
        attrs = dict(dict(devices)["podslice"])
        assert attrs["numWorkers"] == 4
        assert attrs["sliceTopology"] == "4x4"

    def test_gang_workers_see_consistent_world(self):
        def scenario(run):
            p = run.pkg
            shared = run.create(claim(
                p, "gang-channel",
                [req(p, "chan", cls="tpu-rendezvous.google.com")],
                [cfg(p, {"apiVersion": p.configapi.API_VERSION,
                         "kind": "RendezvousConfig"})]))
            run.allocate(shared)
            for w in range(4):
                local = run.create(claim(p, f"w{w}-chips", [slice_req(p)]))
                v = run.pod(local)
                assert v["node"] == f"slice-a-w{w}"
                run.pod(shared, node=v["node"])
        views = pods(both(gang_hosts, scenario))
        envs = [{**views[i]["env"], **views[i + 1]["env"]}
                for i in range(0, 8, 2)]
        assert {v["TPU_TOPOLOGY"] for v in envs} == {"4x4"}
        assert len({v["TPU_COORDINATOR_ADDRESS"] for v in envs}) == 1
        assert {v["TPU_WORKER_ID"] for v in envs} == {"0", "1", "2", "3"}
        assert {v["TPU_NUM_WORKERS"] for v in envs} == {"4"}
        assert len({v["TPU_RENDEZVOUS_CHANNEL"] for v in envs}) == 1
        assert {v["TPU_SLICE_ID"] for v in envs} == {"slice-a"}

    def test_podslice_gang_device_all_or_nothing(self):
        def scenario(run):
            p = run.pkg
            run.allocate(run.create(claim(
                p, "whole-slice", [req(p, cls="tpu-podslice.google.com")])))
            run.allocate(run.create(claim(
                p, "whole-slice-2", [req(p, cls="tpu-podslice.google.com")])))
        out = both(gang_hosts, scenario)
        ((_, _, [(_, _, device)]),) = [e for e in out["log"]
                                       if e[0] == "allocated"]
        assert device == "podslice"
        assert refusals(out) == ["whole-slice-2"]


class TestCELSelectorsDemo:
    def test_product_and_index_selector(self):
        def scenario(run):
            run.pod(run.create(claim(run.pkg, "sel", [req(
                run.pkg, selectors=[
                    'device.attributes["productName"].startsWith("tpu-v5") '
                    '&& device.attributes["index"] == 3'])])))
        (v,) = pods(both(single_host, scenario))
        assert chips(v) == [3]


# -- the configurations on fake H100 hosts, through the port ------------

NODE = "h100-node"


def h100_bed(cards: int, hostname: str = NODE) -> PortE2EBed:
    return PortE2EBed([PORT.discovery.FakeHost(
        generation="h100", num_chips=cards, hostname=hostname)])


def cards_of(bed, node=NODE) -> list:
    """The node's cards in minor order."""
    return sorted(bed.hosts[node].nvidia_cards(), key=lambda c: c.minor)


def uuids(view) -> list[str]:
    return view.env["CUDA_VISIBLE_DEVICES"].split(",")


def assert_cards(bed, view, picked) -> None:
    """The view names exactly ``picked`` (cards), by UUID in minor order,
    with their device nodes, and no TPU variable."""
    picked = sorted(picked, key=lambda c: c.minor)
    assert uuids(view) == [c.uuid for c in picked]
    assert [p for p in view.device_nodes
            if p.removeprefix("/dev/nvidia").isdigit()] == [
        f"/dev/nvidia{c.minor}" for c in picked]
    assert view.env["NVIDIA_VISIBLE_DEVICES"] == "void"
    assert not any(k.startswith(("TPU_VISIBLE", "TPU_CHIPS_PER"))
                   for k in view.env)


@pytest.fixture
def h100_four():
    bed = h100_bed(4)
    yield bed
    bed.shutdown()


def by_uuid(bed, view):
    cards = {c.uuid: c for c in cards_of(bed)}
    return [cards[u] for u in uuids(view)]


class TestH100Configurations:
    def test_dedicated_cards_are_distinct(self, h100_four):
        bed = h100_four
        views = [bed.run_pod(bed.create_claim(
            claim(PORT, f"pod{i}-gpu", [req(PORT)]))) for i in range(4)]
        for v in views:
            assert len(uuids(v)) == 1
            assert_cards(bed, v, by_uuid(bed, v))
            assert any(m["containerPath"].endswith("/libcuda.so.1")
                       for m in v.mounts)
        assert sorted(u for v in views for u in uuids(v)) == sorted(
            c.uuid for c in cards_of(bed))
        with pytest.raises(PORT.allocator.AllocationError):
            bed.schedule(bed.create_claim(claim(PORT, "fifth", [req(PORT)])))

    @pytest.mark.parametrize("sharing,key,value", [
        (("TimeSlicing", {"timeSlicing": {"interval": "Long"}}),
         "TPU_RUNTIME_PREEMPTION_MS", "20"),
        (("Coordinated", {"coordinated": {"dutyCyclePercent": 50}}),
         "TPU_COORDINATOR_DUTY_CYCLE_PCT", "50")])
    def test_shared_claim_names_one_card(self, h100_four, sharing, key,
                                         value):
        bed = h100_four
        strategy, extra = sharing
        shared = bed.create_claim(claim(PORT, "shared-gpu", [req(PORT)], [
            cfg(PORT, chip_config(strategy, **extra))]))
        v1, v2 = bed.run_pod(shared), bed.run_pod(shared)
        assert v1.env == v2.env and len(uuids(v1)) == 1
        assert_cards(bed, v1, by_uuid(bed, v1))
        assert v1.env[key] == value

    def test_core_claim_is_the_whole_card(self, h100_four):
        """One core an H100 (no MIG): a core claim holds its card, and
        the card's chip device is refused while it is held."""
        bed = h100_four
        v = bed.run_pod(bed.create_claim(claim(
            PORT, "core-claim", [req(PORT, cls="tpu-core.google.com")])))
        (card,) = by_uuid(bed, v)
        assert_cards(bed, v, [card])
        with pytest.raises(PORT.allocator.AllocationError):
            bed.schedule(bed.create_claim(claim(PORT, "whole", [req(
                PORT, selectors=[
                    f'device.attributes["index"] == {card.minor}'])])))

    def test_slice_lists_its_cards_in_minor_order(self, h100_four):
        """A 2x1 slice device: two cards, whose UUIDs the claim lists in
        minor order, whatever the cards' order in the probe."""
        bed = h100_four
        c = bed.create_claim(claim(PORT, "pair", [slice_req(PORT, "2x1")]))
        v = bed.run_pod(c)
        picked = by_uuid(bed, v)
        assert len(picked) == 2
        assert_cards(bed, v, picked)
        assert [x.minor for x in picked] == sorted(x.minor for x in picked)
        bed.delete_pod(c, v.node)
        assert not list(Path(bed.drivers[NODE].state.cdi.cdi_root).glob(
            f"*claim_{c.metadata.uid}*"))

    def test_multi_request_claim_lists_every_card(self, h100_four):
        bed = h100_four
        v = bed.run_pod(bed.create_claim(claim(
            PORT, "three", [req(PORT, f"g{i}") for i in range(3)])))
        picked = by_uuid(bed, v)
        assert len(picked) == 3 and len(set(uuids(v))) == 3
        assert_cards(bed, v, picked)

    def test_no_gang_pool_on_h100_nodes(self):
        """Config 5 waits for NVLink slices: an H100 node publishes no
        slice identity, so the controller publishes no gang pool and a
        podslice claim is refused."""
        bed = PortE2EBed([PORT.discovery.FakeHost(
            generation="h100", num_chips=2, hostname=f"g{i}")
            for i in range(2)])
        try:
            assert not [s for s in bed.cluster.list("ResourceSlice")
                        if s.node_selector]
            with pytest.raises(PORT.allocator.AllocationError):
                bed.schedule(bed.create_claim(claim(PORT, "gang", [req(
                    PORT, cls="tpu-podslice.google.com")])))
        finally:
            bed.shutdown()

    def test_cel_selector_on_h100_attributes(self, h100_four):
        bed = h100_four
        card = cards_of(bed)[2]
        v = bed.run_pod(bed.create_claim(claim(PORT, "sel", [req(
            PORT, selectors=[
                'device.attributes["productName"] == '
                '"nvidia-h100-80gb-hbm3" && '
                f'device.attributes["uuid"] == "{card.uuid}"'])])))
        assert_cards(bed, v, [card])
