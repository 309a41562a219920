"""The port's chip-health loop against the JAX package's (the twin of
tests/test_health.py): a failed chip leaves everything the scheduler can
allocate (the chip, its cores, every slice holding it), the
ResourceSlices are republished without them, a prepare on it fails
with the reason, and recovery restores the set, in both packages with
the same published devices after every step.  The NVIDIA rule: a
missing ``/dev/nvidia<minor>`` takes the card's devices out of the
republished slice.  The driver's metrics render through the port's own
registry with the reference's samples."""

import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_driver import BOTH, JAX, PORT  # noqa: E402
from torch_plugin import make_allocated_claim, short_dir  # noqa: E402


def fail_chip(root: Path, idx: int, reason: str = "ecc") -> None:
    (root / f"sys/class/accel/accel{idx}/device/health").write_text(
        reason + "\n")


def heal_chip(root: Path, idx: int) -> None:
    (root / f"sys/class/accel/accel{idx}/device/health").unlink()


def make_bed(pkg, base, host=None, node="n1"):
    cluster = pkg.cluster.FakeCluster()
    cluster.create(pkg.cluster.Node(metadata=pkg.resource.ObjectMeta(
        name=node)))
    root = base / "host"
    host = host or pkg.discovery.FakeHost(num_chips=4, hostname=node)
    backend = host.materialize(root)
    state = pkg.plugin.DeviceState(backend, cluster,
                                   pkg.plugin.DeviceStateConfig(
                                       plugin_root=str(base / "plugin"),
                                       cdi_root=str(base / "cdi"),
                                       node_name=node))
    driver = pkg.plugin.Driver(state, cluster,
                               plugin_dir=str(base / "plugin"))
    driver.start()
    return SimpleNamespace(
        pkg=pkg, cluster=cluster, driver=driver, state=state,
        backend=backend, root=root,
        monitor=pkg.health.HealthMonitor(driver, backend, interval=0))


@pytest.fixture()
def beds():
    base = short_dir("thealth-")
    out = {pkg.name: make_bed(pkg, base / pkg.name[-5:]) for pkg in BOTH}
    yield out
    for b in out.values():
        b.driver.shutdown()
    shutil.rmtree(base, ignore_errors=True)


def published(cluster) -> set[str]:
    return {d.name for sl in cluster.list("ResourceSlice")
            for d in sl.devices}


def unhealthy_gauge(driver) -> float:
    return driver.metrics.registry.get_sample_value(
        "tpu_dra_unhealthy_chips")


def both(beds, fn):
    return fn(beds[JAX.name]), fn(beds[PORT.name])


class TestSysfsHealth:
    """The backends' ``health()`` view, both packages on one tree."""

    def _tree(self, tmp_path):
        return {pkg.name: pkg.discovery.FakeHost(num_chips=4).materialize(
            tmp_path / pkg.name[-5:]) for pkg in BOTH}

    def test_all_healthy_by_default(self, tmp_path):
        assert [b.health() for b in self._tree(tmp_path).values()] == \
            [{}, {}]

    def test_sysfs_health_attr(self, tmp_path):
        backends = self._tree(tmp_path)
        for pkg in BOTH:
            root = tmp_path / pkg.name[-5:]
            fail_chip(root, 2, "hbm uncorrectable ecc")
            (root / "sys/class/accel/accel1/device/health").write_text(
                "ok\n")
        hj, hp = (backends[p.name].health() for p in BOTH)
        assert hp == hj and set(hp) == {2} and "ecc" in hp[2]

    def test_missing_device_node(self, tmp_path):
        backends = self._tree(tmp_path)
        for pkg in BOTH:
            (tmp_path / pkg.name[-5:] / "dev/accel3").unlink()
        hj, hp = (backends[p.name].health() for p in BOTH)
        assert hp == hj and set(hp) == {3} and "missing" in hp[3]


class TestHealthMonitor:
    def test_failure_unpublishes_chip_cores_and_slices(self, beds):
        def run(b):
            steady = b.monitor.check_once()
            before = published(b.cluster)
            fail_chip(b.root, 1, "hbm uncorrectable ecc")
            changed = b.monitor.check_once()
            return (steady, changed, sorted(before),
                    sorted(published(b.cluster)),
                    unhealthy_gauge(b.driver))
        rj, rp = both(beds, run)
        assert rp == rj
        steady, changed, before, after, gauge = rp
        assert steady is False and changed is True
        gone = set(before) - set(after)
        assert "chip-1" in gone
        assert any(n.startswith("chip-1-core-") for n in gone)
        assert all(not n.startswith("slice-2x2") for n in after)
        assert "chip-0" in after and gauge == 1.0

    def test_recovery_republishes_everything(self, beds):
        def run(b):
            before = published(b.cluster)
            fail_chip(b.root, 0, "gone")
            first = b.monitor.check_once()
            heal_chip(b.root, 0)
            second = b.monitor.check_once()
            return (first, second, published(b.cluster) == before,
                    unhealthy_gauge(b.driver))
        assert both(beds, run) == ((True, True, True, 0.0),) * 2

    def test_prepare_on_unhealthy_device_fails_with_reason(self, beds):
        def run(b):
            fail_chip(b.root, 1, "pcie link down")
            b.monitor.check_once()
            with pytest.raises(b.pkg.device_state.PrepareError) as err:
                b.state.prepare(make_allocated_claim(
                    b.pkg, "c1", [("r0", "chip-1")], pool="n1"))
            return str(err.value)
        mj, mp = both(beds, run)
        assert mp == mj and "unhealthy" in mp and "pcie link down" in mp

    def test_healthy_chip_still_prepares_during_failure(self, beds):
        def run(b):
            fail_chip(b.root, 1)
            b.monitor.check_once()
            return b.state.prepare(make_allocated_claim(
                b.pkg, "c2", [("r0", "chip-0")], pool="n1")).to_json()
        pj, pp = both(beds, run)
        assert pp == pj and pp["devices"]

    def test_unchanged_health_does_not_republish(self, beds):
        def run(b):
            fail_chip(b.root, 2)
            return b.monitor.check_once(), b.monitor.check_once()
        assert both(beds, run) == ((True, False),) * 2


class TestHealthHardening:
    def test_vanished_sysfs_entry_reported(self, tmp_path):
        def run(pkg):
            root = tmp_path / pkg.name[-5:]
            backend = pkg.discovery.FakeHost(num_chips=4).materialize(root)
            shutil.rmtree(root / "sys/class/accel/accel3")
            (root / "dev/accel3").unlink()
            return backend.health(), backend.health(expected={0, 1, 2, 3})
        (blind_j, hj), (blind_p, hp) = run(JAX), run(PORT)
        assert (blind_p, hp) == (blind_j, hj)
        assert blind_p == {} and set(hp) == {3} and "vanished" in hp[3]

    def test_monitor_catches_vanished_entry(self, beds):
        def run(b):
            shutil.rmtree(b.root / "sys/class/accel/accel2")
            (b.root / "dev/accel2").unlink()
            return b.monitor.check_once(), "chip-2" in published(b.cluster)
        assert both(beds, run) == ((True, False),) * 2

    def test_failed_republish_retries_next_tick(self, beds):
        def run(b):
            fail_chip(b.root, 1)
            real = b.driver.publish_resources
            calls = {"n": 0}

            def flaky():
                calls["n"] += 1
                raise RuntimeError("api server down")

            b.driver.publish_resources = flaky
            failed = b.monitor.check_once()
            narrowed = "chip-1" not in b.state.allocatable
            b.driver.publish_resources = real
            landed = b.monitor.check_once()
            return (failed, calls["n"], narrowed, landed,
                    "chip-1" in published(b.cluster))
        assert both(beds, run) == ((False, 1, True, True, False),) * 2

    def test_native_backend_shares_sysfs_health(self, tmp_path):
        def run(pkg):
            root = tmp_path / pkg.name[-5:]
            pkg.discovery.FakeHost(num_chips=2).materialize(root)
            try:
                backend = pkg.native.NativeBackend(host_root=str(root))
            except pkg.native.NativeUnavailableError:
                pytest.skip("native shim not buildable here")
            fail_chip(root, 1, "ecc")
            return backend.health(expected={0, 1})
        hj, hp = run(JAX), run(PORT)
        assert hp == hj and set(hp) == {1}


def test_gang_podslice_prepare_refused_on_unhealthy_chip():
    base = short_dir("tgang-")

    def run(pkg):
        host = pkg.discovery.FakeHost(
            num_chips=4, hostname="w0", slice_id="slice-a", topology="4x4",
            worker_id=0, worker_hostnames=("w0", "w1", "w2", "w3"))
        b = make_bed(pkg, base / pkg.name[-5:], host=host, node="w0")
        try:
            fail_chip(b.root, 3, "hbm ecc")
            b.monitor.check_once()
            claim = make_allocated_claim(pkg, "gang", [("r0", "podslice")],
                                         pool="slice-a")
            with pytest.raises(pkg.device_state.PrepareError) as err:
                b.state.prepare(claim)
            heal_chip(b.root, 3)
            b.monitor.check_once()
            return str(err.value), b.state.prepare(claim).to_json()
        finally:
            b.driver.shutdown()
    try:
        (mj, pj), (mp, pp) = run(JAX), run(PORT)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    assert (mp, pp) == (mj, pj)
    assert "podslice" in mp and "chip 3" in mp and pp["devices"]


class TestNvidiaHealth:
    """The port only: a card whose ``/dev/nvidia<minor>`` vanishes
    leaves the republished slice with its core, and comes back when
    the node returns."""

    def test_missing_card_node_unpublishes_the_card(self):
        base = short_dir("tnvh-")
        host = PORT.discovery.FakeHost(generation="h100", num_chips=2,
                                       hostname="g1", nvidia="procfs")
        b = make_bed(PORT, base, host=host, node="g1")
        try:
            before = published(b.cluster)
            assert before == {"chip-4", "chip-4-core-0", "chip-6",
                              "chip-6-core-0", "slice-2x1-at-0-0-0"}
            assert b.monitor.check_once() is False
            (b.root / "dev/nvidia6").unlink()
            seen = []
            b.monitor.listeners.append(seen.append)
            assert b.monitor.check_once() is True
            assert published(b.cluster) == {"chip-4", "chip-4-core-0"}
            assert list(seen[0]) == [6] and "nvidia6" in seen[0][6]
            assert unhealthy_gauge(b.driver) == 1.0
            (b.root / "dev/nvidia6").write_text("")
            assert b.monitor.check_once() is True
            assert published(b.cluster) == before and seen[-1] == {}
            assert unhealthy_gauge(b.driver) == 0.0
        finally:
            b.driver.shutdown()
            shutil.rmtree(base, ignore_errors=True)


class TestDriverMetrics:
    """The port's ``DriverMetrics`` renders the samples
    ``prometheus_client`` renders for the reference's, ``_created``
    aside, and serves them over the HTTP endpoint."""

    def _fill(self, m):
        m.prepare_seconds.labels(outcome="ok").observe(0.003)
        m.prepare_seconds.labels(outcome="error").observe(2.0)
        m.unprepare_seconds.labels(outcome="ok").observe(0.0004)
        m.prepared_claims.set(2)
        m.published_devices.set(13)
        m.unhealthy_chips.set(1)
        m.slice_reconciles.labels(op="create").inc()
        m.slice_reconciles.labels(op="update").inc(2)
        return m.render().decode()

    def test_render_equals_reference_without_created(self):
        jax_text = self._fill(JAX.metrics.DriverMetrics())
        port_text = self._fill(PORT.metrics.DriverMetrics())
        want = "".join(line + "\n" for line in jax_text.splitlines()
                       if "_created" not in line)
        assert port_text == want

    def test_http_endpoint_serves_driver_metrics(self):
        from urllib.request import urlopen
        ep = PORT.httpendpoint.HTTPEndpoint("127.0.0.1:0",
                                            PORT.metrics.DriverMetrics())
        ep.start()
        try:
            base = f"http://{ep.address}"
            body = urlopen(f"{base}/metrics", timeout=5).read()
            assert b"# TYPE tpu_dra_prepared_claims gauge" in body
            assert urlopen(f"{base}/healthz", timeout=5).read() == b"ok"
        finally:
            ep.stop()

    def test_concurrent_updates_are_not_lost(self):
        import threading
        m = PORT.metrics.DriverMetrics()
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            def work():
                for _ in range(2000):
                    m.prepare_seconds.labels(outcome="ok").observe(0.01)
                    m.slice_reconciles.labels(op="update").inc()
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
        get = m.registry.get_sample_value
        assert get("tpu_dra_prepare_seconds_count", {"outcome": "ok"}) == \
            32000.0
        assert get("tpu_dra_resourceslice_reconciles_total",
                   {"op": "update"}) == 32000.0
