"""The port's native allocator core (k8s_dra_driver_tpu_torch/native/
tpualloc.cc) against its Python engine and the JAX package's
(tests/test_native_alloc.py's cases): on the same pools and claims the
port's two engines and the JAX Python engine pick the same devices or
fail with the same message, over the corpus shapes and seeded randomized
pools.  The fallback tests run without the shim."""

import ctypes

import numpy as np
import pytest

from torch_driver import (JAX, PORT, claim, constraint, devices_of, outcome,
                          request, slices_for)

na = PORT.native_alloc


@pytest.fixture(scope="module")
def shim():
    return na.ensure_built()


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Per package: a v5p host's devices as 1, 2 and 4 node pools."""
    tmp = tmp_path_factory.mktemp("hosts")
    host = JAX.discovery.FakeHost(hostname="h", generation="v5p")
    host.materialize(tmp)
    out = {}
    for pkg in (JAX, PORT):
        topo = pkg.discovery.SysfsBackend(host_root=str(tmp), env=host.env(),
                                          hostname="h").enumerate()
        devices = devices_of(pkg, topo)
        out[pkg.name] = {n: slices_for(pkg, devices,
                                       [f"host-{i:02d}" for i in range(n)])
                         for n in (1, 2, 4)}
    return out


def engines(pools, n_hosts, make_claim, allocated=None):
    """[JAX python, port python, port native] outcomes of one claim;
    ``allocated(pkg, slices, nodes)`` gives the claims already holding
    devices."""
    out = []
    for pkg, engine in ((JAX, "python"), (PORT, "python"),
                        (PORT, "native")):
        slices, nodes = pools[pkg.name][n_hosts]
        prior = allocated(pkg, slices, nodes) if allocated else []
        alloc = pkg.allocator.Allocator(engine=engine)
        out.append(outcome(lambda: alloc.allocate(
            make_claim(pkg), slices, pkg.classes.standard_device_classes(),
            nodes=nodes, allocated_claims=prior)))
    return out


def same(outs):
    assert outs[0] == outs[1] == outs[2], outs
    return outs[0]


class TestParity:
    def test_version_and_build_place(self, shim):
        assert na.version().startswith("tpualloc/")
        assert shim == na.nativebuild.BUILD_DIR / "libtpualloc.so"
        handle = ctypes.CDLL(str(shim))
        handle.tpu_alloc_version.restype = ctypes.c_char_p
        assert handle.tpu_alloc_version() == b"tpualloc/0.1.0"

    def test_single_chip(self, pools, shim):
        got = same(engines(pools, 2, lambda pkg: claim(pkg, [request(pkg)])))
        assert got[0] != "AllocationError"

    def test_multi_request_with_constraint(self, pools, shim):
        got = same(engines(pools, 2, lambda pkg: claim(
            pkg, [request(pkg, n, cls="tpu-core.google.com")
                  for n in ("a", "b")],
            [constraint(pkg, "parentUUID", ["a", "b"])])))
        assert len(got) == 2

    def test_allocation_mode_all(self, pools, shim):
        got = same(engines(pools, 2, lambda pkg: claim(pkg, [request(
            pkg, "every", mode=pkg.resource.ALLOCATION_MODE_ALL,
            selectors=['device.attributes["type"] == "chip"'])])))
        assert len(got) == 4

    def test_vacuous_request(self, pools, shim):
        same(engines(pools, 1, lambda pkg: claim(
            pkg, [request(pkg, "none", count=0), request(pkg, "one")])))

    def test_unsatisfiable(self, pools, shim):
        got = same(engines(pools, 2, lambda pkg: claim(
            pkg, [request(pkg, count=99)])))
        assert got[0] == "AllocationError"

    def test_budget_exhaustion(self, pools, shim):
        outs = []
        for pkg, engine in ((JAX, "python"), (PORT, "python"),
                            (PORT, "native")):
            slices, nodes = pools[pkg.name][4]
            alloc = pkg.allocator.Allocator(engine=engine, search_budget=1)
            c = claim(pkg, [request(pkg, count=2)])
            outs.append(outcome(lambda: alloc.allocate(
                c, slices, pkg.classes.standard_device_classes(),
                nodes=nodes)))
        assert same(outs)[0] == "AllocationError"
        assert "search budget" in outs[0][1]

    def test_token_conflicts_from_prior_claims(self, pools, shim):
        def hog(pkg, slices, nodes):
            c = claim(pkg, [request(pkg, count=4)], name="hog")
            c.status.allocation = pkg.allocator.Allocator().allocate(
                c, slices, pkg.classes.standard_device_classes(),
                nodes=nodes)
            return [c]
        got = same(engines(pools, 1, lambda pkg: claim(pkg, [request(pkg)]),
                           allocated=hog))
        assert got[0] == "AllocationError"

    @pytest.mark.parametrize("seed", [7, 11, 2024])
    def test_randomized_pools(self, pools, shim, seed):
        """Seeded random claims over a 4-host pool: pick-identical (or
        identically infeasible) across the three engines."""
        rng = np.random.default_rng(seed)
        classes = ["tpu.google.com", "tpu-core.google.com",
                   "tpu-slice.google.com"]
        for i in range(30):
            n_reqs = int(rng.integers(1, 4))
            spec = [(f"r{r}", int(rng.integers(1, 4)),
                     classes[int(rng.integers(0, 3))])
                    for r in range(n_reqs)]
            con = None
            if rng.random() < 0.4:
                names = [s[0] for s in spec]
                scope = [str(x) for x in rng.choice(names, int(
                    rng.integers(1, n_reqs + 1)), replace=False)]
                attr = ["parentUUID", "generation", "uuid"][
                    int(rng.integers(0, 3))]
                con = (attr, scope)

            def make(pkg, spec=spec, con=con):
                return claim(pkg, [request(pkg, n, count=k, cls=cls)
                                   for n, k, cls in spec],
                             [constraint(pkg, con[0], con[1])] if con else ())
            same(engines(pools, 4, make))


class TestH100Pool:
    def test_engines_pick_the_card_and_refuse_its_core(self, tmp_path, shim):
        topo = PORT.discovery.FakeHost(generation="h100", num_chips=1).\
            materialize(tmp_path).enumerate()
        slices, nodes = slices_for(PORT, devices_of(PORT, topo), ["g0"])
        classes = PORT.classes.standard_device_classes()
        sel = 'device.attributes["productName"] == "nvidia-h100-80gb-hbm3"'
        firsts, refusals = [], []
        for engine in ("python", "native"):
            alloc = PORT.allocator.Allocator(engine=engine)
            first = claim(PORT, [request(PORT, selectors=[sel])], name="card")
            first.status.allocation = alloc.allocate(first, slices, classes,
                                                     nodes=nodes)
            firsts.append(first.status.allocation.results[0].device)
            core = claim(PORT, [request(PORT, cls="tpu-core.google.com")],
                         name="core")
            refusals.append(outcome(lambda: alloc.allocate(
                core, slices, classes, nodes=nodes,
                allocated_claims=[first])))
        assert firsts == ["chip-4", "chip-4"]
        assert refusals[0] == refusals[1]
        assert refusals[0][0] == "AllocationError"


class TestEngineFallback:
    def test_auto_falls_back_when_shim_unavailable(self, pools, tmp_path,
                                                   monkeypatch):
        monkeypatch.setattr(na, "_lib", None)
        monkeypatch.setattr(na, "_load_error", None)
        monkeypatch.setenv("TPU_ALLOC_LIB", str(tmp_path / "missing.so"))
        slices, nodes = pools[PORT.name][2]
        res = PORT.allocator.Allocator(engine="auto").allocate(
            claim(PORT, [request(PORT)]), slices,
            PORT.classes.standard_device_classes(), nodes=nodes)
        assert res.results
        for _ in range(2):
            with pytest.raises(na.NativeAllocUnavailableError):
                na.load()

    def test_native_engine_surfaces_unavailability(self, pools, tmp_path,
                                                   monkeypatch):
        monkeypatch.setattr(na, "_lib", None)
        monkeypatch.setattr(na, "_load_error", None)
        monkeypatch.setenv("TPU_ALLOC_LIB", str(tmp_path / "missing.so"))
        slices, nodes = pools[PORT.name][2]
        with pytest.raises(na.NativeAllocUnavailableError):
            PORT.allocator.Allocator(engine="native").allocate(
                claim(PORT, [request(PORT)]), slices,
                PORT.classes.standard_device_classes(), nodes=nodes)

    def test_unknown_engine_rejected(self):
        with pytest.raises(ValueError, match="engine"):
            PORT.allocator.Allocator(engine="rust")

    def test_engine_from_environment(self, monkeypatch):
        monkeypatch.setenv("TPU_ALLOC_ENGINE", "native")
        assert PORT.allocator.Allocator().engine == "native"
