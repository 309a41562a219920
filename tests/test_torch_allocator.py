"""The port's CEL evaluator, allocator and mini-scheduler against the JAX
package's (tests/test_allocator.py and tests/test_allocator_scale.py):
every scenario runs through both packages on the same pools and claims,
and the two ``AllocationResult``s (picks, node selectors, config
passthrough) or ``AllocationError`` messages must be equal.  The JAX
tests publish through the kubelet plugin's ``ResourceSlicePublisher``;
here both packages' slices are built directly from
``enumerate_host_devices`` (the publisher comes with the plugin)."""

import time

import pytest

from torch_driver import (BOTH, JAX, PORT, as_dict, claim, constraint,
                          devices_of, outcome, picks, request, slices_for)


def host_devices(tmp_path, pkg, **kw):
    """The package's published devices of a fake host tree (written
    once by the JAX package's FakeHost, read by the package's backend)."""
    root = tmp_path / f"{kw.get('generation', 'v5e')}-{kw.get('hostname', 'h')}"
    host = JAX.discovery.FakeHost(**kw)
    if not root.exists():
        host.materialize(root)
    topo = pkg.discovery.SysfsBackend(host_root=str(root), env=host.env(),
                                      hostname=host.hostname).enumerate()
    return devices_of(pkg, topo)


def cluster(tmp_path, pkg, hosts=("tpu-host-0",), generation="v5e",
            only=None):
    """A FakeCluster with one published pool per host, the standard
    classes and the Nodes."""
    c = pkg.cluster.FakeCluster()
    devices = [d for d in host_devices(tmp_path, pkg, generation=generation)
               if only is None or d.attributes["type"] == only]
    slices, nodes = slices_for(pkg, devices, hosts)
    for obj in slices + nodes + list(
            pkg.classes.standard_device_classes().values()):
        c.create(obj)
    return c


def scheduled(tmp_path, scenario, **kw):
    """``scenario(pkg, client)`` on each package's cluster; returns the
    two outcomes, which must be equal."""
    out = []
    for pkg in BOTH:
        c = cluster(tmp_path, pkg, **kw)
        out.append(scenario(pkg, c))
    assert out[1] == out[0]
    return out[1]


def allocate(pkg, client, requests, name="c", **kw):
    """Create and allocate a claim; its picks and node selector, or the
    AllocationError message."""
    cl = client.create(claim(pkg, requests, name=name, **kw))
    try:
        pkg.allocator.allocate_claim(client, cl)
    except pkg.allocator.AllocationError as e:
        return ("AllocationError", str(e))
    alloc = cl.status.allocation
    return picks(alloc), alloc.node_selector, [
        (x.source, x.requests) for x in alloc.config]


# -- CEL -------------------------------------------------------------------

def device(pkg, name="chip-0", **attrs):
    cap = attrs.pop("capacity", {})
    base = {"type": "chip", "generation": "v5e"}
    base.update(attrs)
    return pkg.resource.Device(name=name, attributes=base, capacity=cap)


CEL_CASES = [
    ('device.driver == "tpu.google.com" && '
     'device.attributes["type"] == "chip"', {}),
    ('device.driver == "gpu.nvidia.com"', {}),
    ('device.attributes.productName.startsWith("tpu-")',
     {"productName": "tpu-v5-lite"}),
    ('device.attributes["productName"].contains("v5")',
     {"productName": "tpu-v5-lite"}),
    ('device.attributes.productName.endsWith("v4")',
     {"productName": "tpu-v5-lite"}),
    ('device.attributes["index"] >= 2', {"index": 3}),
    ('device.capacity["hbm"] == 16', {"capacity": {"hbm": 16}}),
    ('device.attributes["generation"] in ["v5e", "v6e"]', {}),
    ('device.attributes["sliceShape"] == "2x2"', {}),
    ('device.attributes["index"] > 1', {}),
    ('!(device.attributes["type"] == "core") && '
     'device.attributes["type"] != "slice"', {}),
    ('device.attributes["note"] == "hello!world"', {"note": "hello!world"}),
    ('device.attributes["productName"] == "nvidia-h100-80gb-hbm3"',
     {"productName": "nvidia-h100-80gb-hbm3"}),
    ('device.attributes["index"] % 2 == 0 || device.name.matches("^chip-")',
     {"index": 3}),
    ("", {}),
]


class TestCEL:
    @pytest.mark.parametrize("expr,attrs", CEL_CASES)
    def test_evaluates_like_jax(self, expr, attrs):
        got = [pkg.allocator.evaluate(expr, device(pkg, **dict(attrs)))
               for pkg in BOTH]
        assert got[0] == got[1]

    @pytest.mark.parametrize("expr", ["__import__('os')", "device.__class__",
                                      "[x for x in []]", "(lambda: 1)()"])
    def test_rejects_unsafe_syntax(self, expr):
        msgs = []
        for pkg in BOTH:
            with pytest.raises(pkg.allocator.CELError) as e:
                pkg.allocator.evaluate(expr, device(pkg))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# -- allocator ---------------------------------------------------------------

SLICE_2X2 = ['device.attributes["sliceShape"] == "2x2"']


class TestAllocator:
    def test_single_chip(self, tmp_path):
        got = scheduled(tmp_path, lambda pkg, c: allocate(
            pkg, c, [request(pkg)]))
        assert got[0][0][2].startswith("chip-")
        assert got[1] == {"kubernetes.io/hostname": "tpu-host-0"}

    def test_prefers_core_with_no_class(self, tmp_path):
        got = scheduled(tmp_path, lambda pkg, c: allocate(
            pkg, c, [request(pkg, cls="")]))
        assert "core" in got[0][0][2]

    def test_two_distinct_chips(self, tmp_path):
        got = scheduled(tmp_path, lambda pkg, c: allocate(
            pkg, c, [request(pkg, count=2)]))
        assert len({p[2] for p in got[0]}) == 2

    @pytest.mark.parametrize("first,second", [
        ([("tpu.google.com", 4, ())], [("tpu.google.com", 1, ())]),
        ([("tpu-slice.google.com", 1, SLICE_2X2)],
         [("tpu.google.com", 1, ())]),
        ([("tpu.google.com", 1, ())],
         [("tpu-slice.google.com", 1, SLICE_2X2)]),
    ])
    def test_tokens_block_later_claims(self, tmp_path, first, second):
        def scenario(pkg, c):
            mk = lambda spec: [request(pkg, f"r{i}", count=n, cls=cls,
                                       selectors=sel)
                               for i, (cls, n, sel) in enumerate(spec)]
            return (allocate(pkg, c, mk(first), name="a"),
                    allocate(pkg, c, mk(second), name="b"))
        a, b = scheduled(tmp_path, scenario)
        assert a[0] != "AllocationError" and b[0] == "AllocationError"

    def test_core_partitions_coexist_on_v5p(self, tmp_path):
        def scenario(pkg, c):
            cores = [request(pkg, n, cls="tpu-core.google.com")
                     for n in ("r0", "r1")]
            return (allocate(pkg, c, cores, name="a"),
                    allocate(pkg, c, [request(pkg, selectors=[
                        'device.attributes["index"] == 0'])], name="b"))
        a, b = scheduled(tmp_path, scenario, hosts=("p0",),
                         generation="v5p")
        assert len({p[2] for p in a[0]}) == 2
        assert b[0] == "AllocationError"

    def test_match_attribute_same_parent(self, tmp_path):
        got = scheduled(tmp_path, lambda pkg, c: allocate(
            pkg, c, [request(pkg, n, cls="tpu-core.google.com")
                     for n in ("r0", "r1")],
            constraints=[constraint(pkg, "parentUUID")]),
            hosts=("p0",), generation="v5p")
        assert len({p[2].rsplit("-core-", 1)[0] for p in got[0]}) == 1

    def test_allocation_mode_all(self, tmp_path):
        got = scheduled(tmp_path, lambda pkg, c: allocate(pkg, c, [
            request(pkg, "all", mode=pkg.resource.ALLOCATION_MODE_ALL)]))
        assert len(got[0]) == 4

    def test_config_passthrough_order(self, tmp_path):
        def scenario(pkg, c):
            r = pkg.resource
            cls = c.get("DeviceClass", "", "tpu.google.com")
            cls.config = [r.DeviceClassConfig(opaque=r.OpaqueConfig(
                driver="tpu.google.com", parameters={"from": "class"}))]
            c.update(cls)
            return allocate(pkg, c, [request(pkg)], configs=[
                r.ClaimConfig(opaque=r.OpaqueConfig(
                    driver="tpu.google.com", parameters={"from": "claim"}))])
        got = scheduled(tmp_path, scenario)
        assert [s for s, _ in got[2]] == ["FromClass", "FromClaim"]

    def test_idempotent(self, tmp_path):
        for pkg in BOTH:
            c = cluster(tmp_path, pkg)
            cl = c.create(claim(pkg, [request(pkg)]))
            pkg.allocator.allocate_claim(c, cl)
            first = cl.status.allocation
            pkg.allocator.allocate_claim(c, cl)
            assert cl.status.allocation is first

    def test_deallocate(self, tmp_path):
        def scenario(pkg, c):
            cl = c.create(claim(pkg, [request(pkg, count=4)], name="a"))
            pkg.allocator.allocate_claim(c, cl)
            pkg.allocator.deallocate_claim(c, cl)
            return allocate(pkg, c, [request(pkg, count=4)], name="b")
        assert len(scheduled(tmp_path, scenario)[0]) == 4

    def test_selector_on_ici_coordinate(self, tmp_path):
        got = scheduled(tmp_path, lambda pkg, c: allocate(
            pkg, c, [request(pkg, selectors=[
                'device.attributes["ici.x"] == 1 && '
                'device.attributes["ici.y"] == 1'])]))
        assert got[0][0][2] == "chip-3"

    def test_unknown_class_rejected(self, tmp_path):
        got = scheduled(tmp_path, lambda pkg, c: allocate(
            pkg, c, [request(pkg, cls="nope.com")]))
        assert got[0] == "AllocationError" and "unknown device class" in got[1]

    def test_other_drivers_slices_ignored(self, tmp_path):
        def scenario(pkg, c):
            for s in c.list("ResourceSlice"):
                s.driver = "gpu.nvidia.com"
                c.update(s)
            return allocate(pkg, c, [request(pkg)])
        assert scheduled(tmp_path, scenario)[0] == "AllocationError"


class TestMultiNode:
    def test_second_node_used_when_first_full(self, tmp_path):
        def scenario(pkg, c):
            a = allocate(pkg, c, [request(pkg, count=4)], name="a")
            b = allocate(pkg, c, [request(pkg, count=4)], name="b")
            return a[1], b[1]
        a, b = scheduled(tmp_path, scenario, hosts=("h0", "h1"))
        assert {a["kubernetes.io/hostname"],
                b["kubernetes.io/hostname"]} == {"h0", "h1"}

    def test_all_requests_on_one_node(self, tmp_path):
        got = scheduled(tmp_path, lambda pkg, c: allocate(
            pkg, c, [request(pkg, "r0", count=3), request(pkg, "r1",
                                                          count=3)]),
            hosts=("h0", "h1"), only="chip")
        assert got[0] == "AllocationError"

    def test_node_selector_pools(self, tmp_path):
        """A label-selected pool reaches only matching nodes, and the
        allocation carries the pool's selector."""
        def scenario(pkg, c):
            r = pkg.resource
            s = c.get("ResourceSlice", "", "s-h0")
            s.node_name, s.node_selector = "", {"zone": "a"}
            c.update(s)
            node = c.get("Node", "", "h0")
            node.metadata.labels = {"zone": "a"}
            c.update(node)
            c.create(pkg.cluster.Node(metadata=r.ObjectMeta(name="h9")))
            return allocate(pkg, c, [request(pkg, count=4)])
        got = scheduled(tmp_path, scenario, hosts=("h0",))
        assert got[1] == {"zone": "a"}

    def test_sibling_prune_distinguishes_raw_attribute_types(self):
        got = []
        for pkg in BOTH:
            r = pkg.resource
            slices, _ = slices_for(pkg, [
                r.Device(name="d0", attributes={"rank": 1}),
                r.Device(name="d1", attributes={"rank": "1"}),
                r.Device(name="d2", attributes={"rank": 1})], ["n0"])
            c = claim(pkg, [r.DeviceRequest(name="r0", count=2)],
                      constraints=[constraint(pkg, "rank")])
            got.append(picks(pkg.allocator.Allocator().allocate(
                c, slices, classes={})))
        assert got[0] == got[1] == [("r0", "n0", "d0"), ("r0", "n0", "d2")]


# -- scale (tests/test_allocator_scale.py) -----------------------------------

N_HOSTS = 64


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """64 v5p hosts of 4 chips, 8 cores and the slice shapes, per
    package."""
    tmp = tmp_path_factory.mktemp("pool")
    out = {}
    for pkg in BOTH:
        devices = host_devices(tmp, pkg, generation="v5p")
        out[pkg.name] = slices_for(
            pkg, devices, [f"host-{i:03d}" for i in range(N_HOSTS)])
    return out


def burst_claim(pkg, i):
    kind = i % 4
    if kind == 0:
        return claim(pkg, [request(pkg)], name=f"chip-{i}")
    if kind == 1:
        return claim(pkg, [request(pkg, count=4)], name=f"quad-{i}")
    if kind == 2:
        return claim(pkg, [request(pkg, cls="tpu-slice.google.com",
                                   selectors=SLICE_2X2)], name=f"slice-{i}")
    return claim(pkg, [request(pkg, count=2, cls="tpu-core.google.com")],
                 [constraint(pkg, "parentUUID", ["r0"])], name=f"cores-{i}")


class TestScale:
    def test_sequence_of_claims_under_1s(self, pools):
        got = {}
        for pkg in BOTH:
            slices, nodes = pools[pkg.name]
            classes = pkg.classes.standard_device_classes()
            alloc, allocated, seq = pkg.allocator.Allocator(), [], []
            t0 = time.perf_counter()
            for i in range(20):
                c = burst_claim(pkg, i)
                c.status.allocation = alloc.allocate(
                    c, slices, classes, nodes=nodes,
                    allocated_claims=allocated)
                allocated.append(c)
                seq.append(picks(c.status.allocation))
            elapsed = time.perf_counter() - t0
            assert elapsed < 1.0, f"{pkg.name}: 20 allocations {elapsed:.2f}s"
            got[pkg.name] = seq
        assert got[PORT.name] == got[JAX.name]

    def test_constrained_pair_fast(self, pools):
        def fn(pkg):
            slices, nodes = pools[pkg.name]
            c = claim(pkg, [request(pkg, count=2, cls="tpu-core.google.com")],
                      [constraint(pkg, "parentUUID", ["r0"])])
            t0 = time.perf_counter()
            res = pkg.allocator.Allocator().allocate(
                c, slices, pkg.classes.standard_device_classes(),
                nodes=nodes)
            assert time.perf_counter() - t0 < 1.0
            return picks(res)
        assert fn(PORT) == fn(JAX)

    @pytest.mark.parametrize("count,budget,limit_s", [
        (3, None, 2.0), (4, 3, None)])
    def test_unsatisfiable_fails_fast(self, pools, count, budget, limit_s):
        msgs = []
        for pkg in BOTH:
            slices, nodes = pools[pkg.name]
            alloc = (pkg.allocator.Allocator() if budget is None
                     else pkg.allocator.Allocator(search_budget=budget))
            c = claim(pkg, [request(pkg, count=count)],
                      [constraint(pkg, "nonexistent", ["r0"])])
            t0 = time.perf_counter()
            msgs.append(outcome(lambda: alloc.allocate(
                c, slices, pkg.classes.standard_device_classes(),
                nodes=nodes)))
            if limit_s is not None:
                assert time.perf_counter() - t0 < limit_s
        assert msgs[0] == msgs[1] and msgs[0][0] == "AllocationError"

    def test_fleet_fillup_whole_chips(self, pools):
        got = {}
        for pkg in BOTH:
            slices, nodes = (x[:8] for x in pools[pkg.name])
            classes = pkg.classes.standard_device_classes()
            alloc, allocated, seen = pkg.allocator.Allocator(), [], []
            for i in range(32):
                c = claim(pkg, [request(pkg)], name=f"fill-{i}")
                c.status.allocation = alloc.allocate(
                    c, slices, classes, nodes=nodes,
                    allocated_claims=allocated)
                allocated.append(c)
                seen.append(picks(c.status.allocation)[0])
            assert len(set(seen)) == 32
            over = claim(pkg, [request(pkg)], name="overflow")
            seen.append(outcome(lambda: alloc.allocate(
                over, slices, classes, nodes=nodes,
                allocated_claims=allocated)))
            got[pkg.name] = seen
        assert got[PORT.name] == got[JAX.name]
        assert got[PORT.name][-1][0] == "AllocationError"


class TestH100Pool:
    """The pool the driver publishes for one live H100 (the probe's
    card), as chip_smoke.py's driver phase allocates it."""

    def test_chip_by_product_then_core_refused(self, tmp_path):
        topo = PORT.discovery.FakeHost(generation="h100", num_chips=1).\
            materialize(tmp_path).enumerate()
        slices, nodes = slices_for(PORT, devices_of(PORT, topo), ["g0"])
        classes = PORT.classes.standard_device_classes()
        alloc = PORT.allocator.Allocator()
        first = claim(PORT, [request(PORT, selectors=[
            'device.attributes["productName"] == "nvidia-h100-80gb-hbm3"'])],
            name="card")
        first.status.allocation = alloc.allocate(first, slices, classes,
                                                 nodes=nodes)
        assert picks(first.status.allocation) == [("r0", "g0", "chip-4")]
        core = claim(PORT, [request(PORT, cls="tpu-core.google.com")],
                     name="core")
        got = outcome(lambda: alloc.allocate(core, slices, classes,
                                             nodes=nodes,
                                             allocated_claims=[first]))
        assert got[0] == "AllocationError"
        assert "no eligible devices" in got[1]
        assert as_dict(first.status.allocation)["node_selector"] == {
            "kubernetes.io/hostname": "g0"}
