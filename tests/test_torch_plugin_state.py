"""The port's DeviceState / CDI / checkpoint / sharing against the JAX
package's (the twin of tests/test_plugin_state.py).

On the TPU fake hosts every scenario runs through both packages, each on
its own tree, and what the two wrote (CDI standard and claim specs,
checkpoint generations, time-slicing and coordinator policies) is
compared byte for byte with the tree's root masked, beside the
reference test's own assertions on the port.  A checkpoint written by
either package loads in the other.  On the fake NVIDIA trees each
row of the NVIDIA container contract (plugin/cdi.py) is asserted, and
every spec validates against the vendored CDI schema."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from helpers import chip_config  # noqa: E402
from torch_driver import BOTH, JAX, PORT  # noqa: E402
from torch_plugin import (make_allocated_claim, snapshot,  # noqa: E402
                          start_fake_deployment_controller)

API_VERSION = JAX.configapi.API_VERSION
IMAGE = "registry.local/tpu-dra-driver:test"


@pytest.fixture(autouse=True)
def no_sleep(monkeypatch):
    for pkg in BOTH:
        monkeypatch.setattr(pkg.plugin.DeviceState, "_sleep",
                            staticmethod(lambda s: None))


def make_env(pkg, root, host=None, node_name="tpu-host-0", **cfg):
    """A DeviceState on a fake host tree under ``root`` + a fake cluster
    with the kubelet stand-in for coordinator Deployments."""
    host = host or pkg.discovery.FakeHost()
    backend = host.materialize(root / "host")
    cluster = pkg.cluster.FakeCluster()
    start_fake_deployment_controller(pkg, cluster)
    config = pkg.plugin.DeviceStateConfig(
        plugin_root=str(root / "plugin"), cdi_root=str(root / "cdi"),
        node_name=node_name, **{"coordinator_image": IMAGE, **cfg})
    state = pkg.plugin.DeviceState(backend, cluster, config)
    return SimpleNamespace(pkg=pkg, state=state, cluster=cluster,
                           root=root, host=host)


@pytest.fixture
def twins(tmp_path):
    return {pkg.name: make_env(pkg, tmp_path / pkg.name) for pkg in BOTH}


def both(twins, fn):
    """``fn(env)`` on each package's env: (JAX result, port result)."""
    return fn(twins[JAX.name]), fn(twins[PORT.name])


def same_trees(twins):
    jax_files = snapshot(twins[JAX.name].root)
    port_files = snapshot(twins[PORT.name].root)
    assert list(port_files) == list(jax_files)
    for name in jax_files:
        assert port_files[name] == jax_files[name], name
    return port_files


def refusal(env, claim_fn, exc_attr="PrepareError", exc_mod="plugin"):
    exc = getattr(getattr(env.pkg, exc_mod), exc_attr)
    with pytest.raises(exc) as err:
        env.state.prepare(claim_fn(env.pkg))
    return str(err.value)


def claim_spec(env, uid):
    return env.state.cdi.read_spec(f"tpu.google.com-claim_{uid}.json")


def claim_env(env, uid):
    return claim_spec(env, uid)["devices"][0]["containerEdits"]["env"]


class TestStandardSpec:
    def test_written_at_startup(self, twins):
        files = same_trees(twins)
        assert "cdi/tpu.google.com-chip.json" in files
        spec = twins[PORT.name].state.cdi.read_spec(
            "tpu.google.com-chip.json")
        names = {d["name"] for d in spec["devices"]}
        assert "chip-0" in names and "slice-2x2-at-0-0-0" in names
        chip0 = next(d for d in spec["devices"] if d["name"] == "chip-0")
        assert {"path": "/dev/accel0"} in \
            chip0["containerEdits"]["deviceNodes"]
        assert "TPU_SKIP_MDS_QUERY=true" in spec["containerEdits"]["env"]
        assert any(m["containerPath"] == "/usr/lib/libtpu.so"
                   for m in spec["containerEdits"]["mounts"])

    def test_core_partition_entry(self, twins):
        same_trees(twins)
        spec = twins[PORT.name].state.cdi.read_spec(
            "tpu.google.com-chip.json")
        core = next(d for d in spec["devices"]
                    if d["name"] == "chip-1-core-0")
        assert {"path": "/dev/accel1"} in \
            core["containerEdits"]["deviceNodes"]
        assert "env" not in core["containerEdits"]


class TestPrepareExclusive:
    def test_single_chip(self, twins):
        pj, pp = both(twins, lambda e: e.state.prepare(
            make_allocated_claim(e.pkg, "c1", [("r0", "chip-2")])).to_json())
        assert pp == pj
        assert pp["devices"][0]["cdi_device_ids"] == [
            "tpu.google.com/chip=chip-2", "tpu.google.com/claim=uid-c1"]
        same_trees(twins)
        env_list = claim_env(twins[PORT.name], "uid-c1")
        assert "TPU_VISIBLE_CHIPS=2" in env_list
        assert "TPU_CHIPS_PER_HOST_BOUNDS=2,2,1" in env_list

    def test_slice_claim_exposes_all_member_chips(self, twins):
        pj, pp = both(twins, lambda e: e.state.prepare(make_allocated_claim(
            e.pkg, "c2", [("r0", "slice-2x2-at-0-0-0")])).to_json())
        assert pp == pj
        assert pp["devices"][0]["chip_indices"] == [0, 1, 2, 3]
        same_trees(twins)
        assert "TPU_VISIBLE_CHIPS=0,1,2,3" in \
            claim_env(twins[PORT.name], "uid-c2")

    def test_idempotent(self, twins):
        def run(e):
            claim = make_allocated_claim(e.pkg, "c1", [("r0", "chip-0")])
            return e.state.prepare(claim) is e.state.prepare(claim)
        assert both(twins, run) == (True, True)
        same_trees(twins)

    def test_unknown_device_rejected(self, twins):
        mj, mp = both(twins, lambda e: refusal(
            e, lambda p: make_allocated_claim(p, "c1", [("r0", "chip-9")])))
        assert mp == mj and "does not exist" in mp

    def test_unallocated_claim_rejected(self, twins):
        def unallocated(pkg):
            claim = make_allocated_claim(pkg, "c1", [("r0", "chip-0")])
            claim.status.allocation = None
            return claim
        mj, mp = both(twins, lambda e: refusal(e, unallocated))
        assert mp == mj and "no allocation" in mp


def ts_claim(pkg, name="ts", device="chip-1", interval="Medium"):
    return make_allocated_claim(
        pkg, name, [("r0", device)],
        configs=[("FromClaim", [], chip_config(
            "TimeSlicing", timeSlicing={"interval": interval}))])


class TestTimeSlicing:
    def test_policy_applied_and_reset(self, twins):
        def prepare(e):
            e.state.prepare(ts_claim(e.pkg))
            return e.state.timeslicing.current_policy(1)
        assert both(twins, prepare) == (5, 5)
        same_trees(twins)
        assert "TPU_RUNTIME_PREEMPTION_MS=5" in \
            claim_env(twins[PORT.name], "uid-ts")

        def unprepare(e):
            e.state.unprepare("uid-ts")
            return e.state.timeslicing.current_policy(1)
        assert both(twins, unprepare) == (0, 0)
        same_trees(twins)

    def test_rejected_on_core_partition(self, twins):
        def claim(pkg):
            return make_allocated_claim(
                pkg, "ts", [("r0", "chip-0-core-0")],
                configs=[("FromClaim", ["r0"], {
                    "apiVersion": API_VERSION, "kind": "TpuPartitionConfig",
                    "sharing": {"strategy": "TimeSlicing"}})])
        mj, mp = both(twins, lambda e: refusal(e, claim))
        assert mp == mj and "not supported on core" in mp


def coord_claim(pkg, name="co", devices=("chip-0", "chip-1"), duty=50,
                **extra):
    return make_allocated_claim(
        pkg, name, [(f"r{i}", d) for i, d in enumerate(devices)],
        configs=[("FromClaim", [], chip_config(
            "Coordinated", coordinated={"dutyCyclePercent": duty,
                                        **extra}))])


class TestCoordinated:
    def test_daemon_lifecycle(self, twins):
        pj, pp = both(twins, lambda e: e.state.prepare(
            coord_claim(e.pkg)).to_json())
        assert pp == pj and len(pp["coordinatorIDs"]) == 1
        files = same_trees(twins)
        port = twins[PORT.name]
        deps = port.cluster.list("Deployment")
        assert len(deps) == 1 and deps[0].ready
        jdep = twins[JAX.name].cluster.list("Deployment")[0]
        assert deps[0].spec == json.loads(json.dumps(jdep.spec).replace(
            str(twins[JAX.name].root), str(port.root)))
        env_list = claim_env(port, "uid-co")
        assert "TPU_COORDINATOR_DUTY_CYCLE_PCT=50" in env_list
        mounts = claim_spec(port, "uid-co")["devices"][0][
            "containerEdits"]["mounts"]
        assert any(m["containerPath"] == "/coordination" for m in mounts)
        policy = json.loads(files[
            f"plugin/coordinator/{pp['coordinatorIDs'][0]}/policy.json"])
        assert policy["dutyCyclePercent"] == 50
        assert policy["chips"] == [0, 1]

        both(twins, lambda e: e.state.unprepare("uid-co"))
        assert port.cluster.list("Deployment") == []
        same_trees(twins)

    def test_per_device_hbm_limits(self, twins):
        pj, pp = both(twins, lambda e: e.state.prepare(coord_claim(
            e.pkg, devices=("chip-0",), duty=100,
            perDeviceHbmLimits={"default": "8Gi"})).to_json())
        assert pp == pj
        files = same_trees(twins)
        uuid0 = twins[PORT.name].state.allocatable["chip-0"].uuids[0]
        policy = json.loads(files[
            f"plugin/coordinator/{pp['coordinatorIDs'][0]}/policy.json"])
        assert policy["hbmLimits"][uuid0] == 8 * 1024 ** 3


class TestCoordinatorFailureModes:
    """Create errors keep their root cause, readiness timeouts carry
    pod diagnostics, and there is no default image, in both
    packages with the same messages."""

    def _manager(self, env, cluster, image="registry.local/d:test"):
        pkg = env.pkg
        return pkg.sharing.CoordinatorManager(
            cluster, str(env.root / "mgr"), "tpu-host-0", image=image,
            backoff=pkg.backoff.Backoff(duration_s=0.001, steps=2,
                                        jitter=0))

    def _daemon(self, env, mgr):
        return mgr.new_daemon(
            "uid-123456789012", [env.state.allocatable["chip-0"]],
            env.pkg.configapi.CoordinatedSettings(duty_cycle_percent=50))

    def test_rbac_denial_is_not_masked_as_adoption(self, twins):
        def run(env):
            class ForbiddenCluster(env.pkg.cluster.FakeCluster):
                def create(self, obj):
                    raise RuntimeError("deployments.apps is forbidden: "
                                       "User cannot create resource (403)")
            daemon = self._daemon(env, self._manager(env,
                                                     ForbiddenCluster()))
            with pytest.raises(env.pkg.sharing.SharingError) as err:
                daemon.start()
            return str(err.value)
        mj, mp = both(twins, run)
        assert mp == mj
        assert "creating coordinator deployment" in mp and "403" in mp

    def test_already_exists_adopts(self, twins):
        def run(env):
            cluster = env.pkg.cluster.FakeCluster()
            start_fake_deployment_controller(env.pkg, cluster)
            daemon = self._daemon(env, self._manager(env, cluster))
            daemon.start()
            daemon.start()             # restart-idempotent: no raise
            return [d.metadata.name for d in cluster.list("Deployment")]
        nj, np_ = both(twins, run)
        assert np_ == nj and len(np_) == 1

    def test_missing_image_fails_at_prepare_time(self, twins):
        def run(env):
            mgr = self._manager(env, env.pkg.cluster.FakeCluster(),
                                image="")
            with pytest.raises(env.pkg.sharing.SharingError) as err:
                self._daemon(env, mgr).start()
            assert mgr.client.list("Deployment") == []
            return str(err.value)
        mj, mp = both(twins, run)
        assert mp == mj and "no coordinator image" in mp

    def test_ready_timeout_reports_crashloop_pod(self, twins):
        def run(env):
            pkg = env.pkg
            cluster = pkg.cluster.FakeCluster()     # never ready
            mgr = self._manager(env, cluster)
            daemon = self._daemon(env, mgr)
            daemon.start()
            cluster.create(pkg.cluster.Pod(
                metadata=pkg.resource.ObjectMeta(
                    name=f"{daemon.name}-abc12", namespace=mgr.namespace,
                    labels={"tpu.google.com/coordinator-id": daemon.id}),
                phase="Pending",
                raw={"status": {"containerStatuses": [{
                    "restartCount": 4,
                    "state": {"waiting": {
                        "reason": "CrashLoopBackOff",
                        "message": "back-off 40s restarting failed "
                                   "container"}}}]}}))
            with pytest.raises(pkg.sharing.SharingError) as err:
                daemon.assert_ready(sleep=lambda s: None)
            return str(err.value)
        mj, mp = both(twins, run)
        assert mp == mj
        for part in ("never became ready", "deployment 0/1 ready",
                     "CrashLoopBackOff", "4 restarts"):
            assert part in mp

    def test_ready_timeout_reports_deployment_deleted(self, twins):
        def run(env):
            cluster = env.pkg.cluster.FakeCluster()
            mgr = self._manager(env, cluster)
            daemon = self._daemon(env, mgr)
            daemon.start()
            cluster.delete("Deployment", mgr.namespace, daemon.name)
            with pytest.raises(env.pkg.sharing.SharingError) as err:
                daemon.assert_ready(sleep=lambda s: None)
            return str(err.value)
        mj, mp = both(twins, run)
        assert mp == mj and "deployment not found" in mp


def ts_config(source, interval, requests=()):
    return (source, list(requests), chip_config(
        "TimeSlicing", timeSlicing={"interval": interval}))


class TestConfigPrecedence:
    def _policies(self, twins, assignments, configs):
        def run(e):
            e.state.prepare(make_allocated_claim(e.pkg, "p", assignments,
                                                 configs=configs))
            return [e.state.timeslicing.current_policy(i) for i in (0, 1)]
        pj, pp = both(twins, run)
        assert pp == pj
        same_trees(twins)
        return pp

    def test_claim_beats_class(self, twins):
        assert self._policies(twins, [("r0", "chip-0")], [
            ts_config("FromClass", "Long"),
            ts_config("FromClaim", "Short")])[0] == 1

    def test_later_beats_earlier_within_source(self, twins):
        assert self._policies(twins, [("r0", "chip-0")], [
            ts_config("FromClaim", "Long"),
            ts_config("FromClaim", "Medium")])[0] == 5

    def test_scoped_config_only_governs_its_request(self, twins):
        assert self._policies(
            twins, [("r0", "chip-0"), ("r1", "chip-1")],
            [ts_config("FromClaim", "Short", ["r1"])]) == [0, 1]

    def test_scoped_type_mismatch_errors(self, twins):
        mj, mp = both(twins, lambda e: refusal(
            e, lambda p: make_allocated_claim(
                p, "p", [("r0", "chip-0-core-0")],
                configs=[("FromClaim", ["r0"], chip_config("Exclusive"))])))
        assert mp == mj and "cannot govern" in mp

    def test_invalid_config_rejected(self, twins):
        mj, mp = both(twins, lambda e: refusal(
            e, lambda p: make_allocated_claim(
                p, "p", [("r0", "chip-0")],
                configs=[("FromClaim", [], {"apiVersion": API_VERSION,
                                            "kind": "Nope"})])))
        assert mp == mj and "invalid opaque config" in mp


def restart(env):
    """A second DeviceState over the same plugin root and host tree."""
    pkg = env.pkg
    backend = env.host.materialize(env.root / "host")
    return pkg.plugin.DeviceState(backend, env.cluster, env.state.config)


class TestRestartSafety:
    def test_prepared_claims_survive_restart(self, twins):
        def run(e):
            e.state.prepare(make_allocated_claim(e.pkg, "c",
                                                 [("r0", "chip-0")]))
            state2 = restart(e)
            kept = {u: p.to_json() for u, p in state2.prepared.items()}
            state2.unprepare("uid-c")
            return kept, "uid-c" in state2.prepared
        (kj, gj), (kp, gp) = both(twins, run)
        assert kp == kj and "uid-c" in kp and not gp and not gj
        same_trees(twins)

    def test_coordinator_teardown_after_restart(self, twins):
        def run(e):
            e.state.prepare(coord_claim(e.pkg, "c", ("chip-0",), duty=10))
            before = len(e.cluster.list("Deployment"))
            restart(e).unprepare("uid-c")
            return before, len(e.cluster.list("Deployment"))
        assert both(twins, run) == ((1, 0), (1, 0))
        same_trees(twins)

    def test_unprepare_unknown_claim_is_noop(self, twins):
        both(twins, lambda e: e.state.unprepare("uid-never-seen"))
        same_trees(twins)

    def test_corrupt_checkpoint_detected(self, tmp_path):
        def run(pkg):
            mgr = pkg.plugin.CheckpointManager(str(tmp_path / pkg.name))
            raw = json.loads(mgr.path.read_text())
            raw["v1"]["preparedClaims"] = {"evil": {"claimUID": "evil"}}
            mgr.path.write_text(json.dumps(raw))
            with pytest.raises(pkg.plugin.ChecksumError) as err:
                mgr.load()
            return str(err.value).replace(str(tmp_path / pkg.name), "<R>")
        assert run(PORT) == run(JAX)


class TestCheckpointAcrossPackages:
    """A node switches plugin without losing its prepared claims: each
    package loads the other's checkpoint, and a restarted plugin of the
    other package unprepares what the first one prepared."""

    def _prepare(self, env):
        env.state.prepare(make_allocated_claim(env.pkg, "a",
                                               [("r0", "chip-1")]))
        env.state.prepare(ts_claim(env.pkg, "b", "chip-2", "Short"))
        env.state.prepare(make_allocated_claim(
            env.pkg, "c", [("r0", "chip-3-core-0")]))
        return {u: p.to_json() for u, p in env.state.prepared.items()}

    @pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                             ids=["jax-to-port", "port-to-jax"])
    def test_cross_load(self, tmp_path, writer, reader):
        env = make_env(writer, tmp_path)
        written = self._prepare(env)
        loaded = reader.plugin.CheckpointManager(
            str(tmp_path / "plugin")).load()
        assert {u: p.to_json() for u, p in loaded.items()} == written
        # the other package's plugin, restarted over the same roots,
        # serves and tears down those claims from the checkpoint alone
        state = reader.plugin.DeviceState(
            reader.discovery.FakeHost().materialize(tmp_path / "host2"),
            reader.cluster.FakeCluster(), reader.plugin.DeviceStateConfig(
                plugin_root=str(tmp_path / "plugin"),
                cdi_root=str(tmp_path / "cdi"), node_name="tpu-host-0"))
        assert sorted(state.prepared) == ["uid-a", "uid-b", "uid-c"]
        for uid in ("uid-a", "uid-b", "uid-c"):
            state.unprepare(uid)
        assert state.prepared == {}
        assert state.timeslicing.current_policy(2) == 0
        assert sorted(p.name for p in (tmp_path / "cdi").iterdir()) == [
            "tpu.google.com-chip.json"]


class TestMultiHostRendezvous:
    def test_gang_worker_env(self, tmp_path):
        def run(pkg):
            host = pkg.discovery.fake_slice_hosts(4, topology="4x4")[1]
            dm = pkg.devicemodel
            env = make_env(pkg, tmp_path / pkg.name, host=host,
                           node_name=host.hostname, coordinator_image="",
                           device_kinds=(dm.KIND_CHIP, dm.KIND_CORE,
                                         dm.KIND_SLICE))
            scoped = refusal(env, lambda p: make_allocated_claim(
                p, "gang2", [("r0", "slice-2x2-at-2-0-0")],
                configs=[("FromClaim", ["r0"], {
                    "apiVersion": API_VERSION,
                    "kind": "RendezvousConfig"})]))
            prepared = env.state.prepare(make_allocated_claim(
                pkg, "gang", [("r0", "slice-2x2-at-2-0-0")],
                configs=[("FromClaim", [], {
                    "apiVersion": API_VERSION,
                    "kind": "RendezvousConfig"})]))
            return (scoped, prepared.to_json(), claim_env(env, "uid-gang"),
                    snapshot(env.root))
        jax_out, port_out = run(JAX), run(PORT)
        assert port_out == jax_out
        assert "TPU_SLICE_ID=slice-a" in port_out[2]
        assert port_out[1]["devices"][0]["chip_indices"] == [0, 1, 2, 3]


class TestCDISchemaValidation:
    def test_baseline_prepares_write_schema_valid_specs(self, twins):
        claims = [
            lambda p: make_allocated_claim(p, "s-ex", [("r0", "chip-2")]),
            lambda p: ts_claim(p, "s-ts", "chip-1", "Short"),
            lambda p: coord_claim(p, "s-co", ("chip-0",)),
            lambda p: make_allocated_claim(
                p, "s-sl", [("r0", "slice-2x2-at-0-0-0")]),
        ]

        def run(e):
            for make in claims:
                e.state.prepare(make(e.pkg))
        both(twins, run)
        same_trees(twins)
        port = twins[PORT.name]
        specs = sorted((port.root / "cdi").glob("*.json"))
        assert len(specs) >= 1 + len(claims)
        for path in specs:
            PORT.cdi_schema.validate_spec(json.loads(path.read_text()))

    def test_write_rejects_schema_violations(self, tmp_path):
        good = {"cdiVersion": "0.6.0", "kind": "tpu.google.com/chip",
                "devices": [{"name": "chip-0", "containerEdits": {}}]}
        bad_cases = [
            ("missing kind", {k: v for k, v in good.items()
                              if k != "kind"}),
            ("unqualified kind", dict(good, kind="chips")),
            ("bad device name", dict(good, devices=[
                {"name": "-leading-dash", "containerEdits": {}}])),
            ("missing containerEdits", dict(good, devices=[
                {"name": "chip-0"}])),
            ("env not K=V", dict(good, containerEdits={
                "env": ["NO_EQUALS_SIGN"]})),
            ("relative device node", dict(good, devices=[
                {"name": "chip-0", "containerEdits": {
                    "deviceNodes": [{"path": "dev/accel0"}]}}])),
            ("mount missing containerPath", dict(good, containerEdits={
                "mounts": [{"hostPath": "/lib/libtpu.so"}]})),
            ("relative mount", dict(good, containerEdits={
                "mounts": [{"hostPath": "lib/libcuda.so.1",
                            "containerPath": "/usr/lib/libcuda.so.1"}]})),
            ("unknown version", dict(good, cdiVersion="9.9.9")),
        ]

        def run(pkg):
            root = tmp_path / pkg.name / "cdi"
            handler = pkg.cdi.CDIHandler(str(root))
            handler._write("ok.json", dict(good))
            handler._write("empty.json", dict(good, devices=[]))
            messages = []
            for label, spec in bad_cases:
                with pytest.raises(pkg.cdi_schema.CDISchemaError) as err:
                    handler._write("bad.json", spec)
                assert not (root / "bad.json").exists(), label
                messages.append(str(err.value))
            return messages
        assert run(PORT) == run(JAX)


# --------------------------------------------------------------------------
# The NVIDIA container contract (plugin/cdi.py), on fake NVIDIA trees
# --------------------------------------------------------------------------

def nvidia_env(tmp_path, form="procfs", num_chips=2, drop=(),
               host_driver_root=None):
    """The port's DeviceState on a fake H100 host whose tree is also the
    driver root, so the common nodes and NVML are looked for there;
    ``drop``: tree paths removed before the plugin starts;
    ``host_driver_root``: the tree's root as the node sees it."""
    host = PORT.discovery.FakeHost(generation="h100", num_chips=num_chips,
                                   hostname="gpu-host-0", nvidia=form)
    root = tmp_path / "host"
    backend = host.materialize(root)
    for rel in drop:
        (root / rel).unlink()
    cluster = PORT.cluster.FakeCluster()
    state = PORT.plugin.DeviceState(backend, cluster,
                                    PORT.plugin.DeviceStateConfig(
                                        plugin_root=str(tmp_path / "plugin"),
                                        cdi_root=str(tmp_path / "cdi"),
                                        node_name="gpu-host-0",
                                        driver_root=str(root),
                                        host_driver_root=host_driver_root))
    return SimpleNamespace(pkg=PORT, state=state, cluster=cluster,
                           root=tmp_path, tree=root, host=host)


def standard(env):
    return env.state.cdi.read_spec("tpu.google.com-chip.json")


def all_specs_valid(env):
    specs = sorted((env.root / "cdi").glob("*.json"))
    for path in specs:
        PORT.cdi_schema.validate_spec(json.loads(path.read_text()))
    return len(specs)


LIBDIR = "usr/lib/x86_64-linux-gnu"


class TestNvidiaContract:
    def test_host_kind(self, tmp_path):
        env = nvidia_env(tmp_path)
        assert env.state.nvidia
        assert not make_env(PORT, tmp_path / "tpu").state.nvidia

    def test_card_nodes_per_device(self, tmp_path):
        env = nvidia_env(tmp_path)
        devices = {d["name"]: d["containerEdits"]
                   for d in standard(env)["devices"]}
        # the probe's two cards, minors 4 and 6; a core is its card
        assert devices["chip-4"] == {"deviceNodes": [{"path": "/dev/nvidia4"}]}
        assert devices["chip-6"] == {"deviceNodes": [{"path": "/dev/nvidia6"}]}
        assert devices["chip-4-core-0"] == devices["chip-4"]
        for edits in devices.values():
            assert all(not n["path"].startswith("/dev/accel")
                       for n in edits.get("deviceNodes", []))
        assert all_specs_valid(env) == 1

    def test_common_edits(self, tmp_path):
        env = nvidia_env(tmp_path)
        common = standard(env)["containerEdits"]
        assert common["deviceNodes"] == [
            {"path": "/dev/nvidiactl"}, {"path": "/dev/nvidia-uvm"},
            {"path": "/dev/nvidia-uvm-tools"}]
        assert common["env"] == ["NVIDIA_VISIBLE_DEVICES=void"]
        # procfs form: libcuda only, no NVML beside it
        assert common["mounts"] == [{
            "hostPath": str(env.tree / LIBDIR / "libcuda.so.1"),
            "containerPath": PORT.cdi.CONTAINER_LIBCUDA_PATH,
            "options": ["ro", "bind"]}]
        assert PORT.cdi.CONTAINER_LIBCUDA_PATH == \
            "/usr/local/nvidia/lib64/libcuda.so.1"

    def test_common_nodes_only_where_present(self, tmp_path):
        env = nvidia_env(tmp_path, drop=("dev/nvidia-uvm-tools",
                                         "dev/nvidia-uvm"))
        assert standard(env)["containerEdits"]["deviceNodes"] == [
            {"path": "/dev/nvidiactl"}]

    def test_nvml_mounted_beside_libcuda(self, tmp_path):
        env = nvidia_env(tmp_path, form="driver")
        mounts = standard(env)["containerEdits"]["mounts"]
        assert [(m["hostPath"], m["containerPath"]) for m in mounts] == [
            (str(env.tree / LIBDIR / "libcuda.so.1"),
             "/usr/local/nvidia/lib64/libcuda.so.1"),
            (str(env.tree / LIBDIR / "libnvidia-ml.so.1"),
             "/usr/local/nvidia/lib64/libnvidia-ml.so.1")]
        # the driver form's stand-in /dev/nvidia0 is no card
        names = {d["name"] for d in standard(env)["devices"]}
        assert "chip-0" not in names and {"chip-4", "chip-6"} <= names
        assert all_specs_valid(env) == 1

    def test_host_paths_as_the_node_sees_them(self, tmp_path):
        """A containerized plugin (driver root ``/host`` in the chart)
        finds the driver's files under its driver root, and its mounts'
        hostPaths name them where the node's runtime resolves them."""
        env = nvidia_env(tmp_path, form="driver", host_driver_root="/")
        common = standard(env)["containerEdits"]
        assert [(m["hostPath"], m["containerPath"])
                for m in common["mounts"]] == [
            (f"/{LIBDIR}/libcuda.so.1",
             "/usr/local/nvidia/lib64/libcuda.so.1"),
            (f"/{LIBDIR}/libnvidia-ml.so.1",
             "/usr/local/nvidia/lib64/libnvidia-ml.so.1")]
        assert common["deviceNodes"] == [
            {"path": "/dev/nvidiactl"}, {"path": "/dev/nvidia-uvm"},
            {"path": "/dev/nvidia-uvm-tools"}]
        node = nvidia_env(tmp_path / "n", form="driver",
                          host_driver_root="/node/")
        assert [m["hostPath"] for m in standard(node)["containerEdits"][
            "mounts"]] == [f"/node/{LIBDIR}/libcuda.so.1",
                           f"/node/{LIBDIR}/libnvidia-ml.so.1"]
        # absent where the node's root has it: no mount
        bare = nvidia_env(tmp_path / "b", host_driver_root="/",
                          drop=(f"{LIBDIR}/libcuda.so.1",))
        assert "mounts" not in standard(bare)["containerEdits"]
        assert all_specs_valid(env) == 1

    def test_no_libcuda_no_mount(self, tmp_path):
        env = nvidia_env(tmp_path, drop=(f"{LIBDIR}/libcuda.so.1",))
        assert "mounts" not in standard(env)["containerEdits"]
        assert all_specs_valid(env) == 1

    def test_chip_claim_names_the_card_by_uuid(self, tmp_path):
        env = nvidia_env(tmp_path)
        prepared = env.state.prepare(make_allocated_claim(
            PORT, "g1", [("r0", "chip-6")]))
        assert prepared.devices[0].cdi_device_ids == [
            "tpu.google.com/chip=chip-6", "tpu.google.com/claim=uid-g1"]
        uuid6 = PORT.discovery.H100_PROBE[1].uuid
        assert claim_env(env, "uid-g1") == [f"CUDA_VISIBLE_DEVICES={uuid6}"]
        assert all_specs_valid(env) == 2

    def test_several_cards_in_minor_order(self, tmp_path):
        env = nvidia_env(tmp_path, num_chips=3)
        env.state.prepare(make_allocated_claim(
            PORT, "g3", [("r0", "chip-6"), ("r1", "chip-0"),
                         ("r2", "chip-4")]))
        by_minor = {c.index: c.uuid for c in env.state.topology.chips}
        assert sorted(by_minor) == [0, 4, 6]
        assert claim_env(env, "uid-g3") == [
            "CUDA_VISIBLE_DEVICES=" + ",".join(by_minor[m]
                                               for m in (0, 4, 6))]

    def test_core_claim_sees_its_card(self, tmp_path):
        env = nvidia_env(tmp_path)
        env.state.prepare(make_allocated_claim(
            PORT, "k", [("r0", "chip-4-core-0")]))
        env_list = claim_env(env, "uid-k")
        assert env_list == [
            f"CUDA_VISIBLE_DEVICES={PORT.discovery.H100_PROBE[0].uuid}"]
        assert not any(e.startswith(("TPU_VISIBLE", "TPU_CHIPS_PER_HOST"))
                       for e in env_list)

    def test_time_sliced_claim_keeps_the_sharing_names(self, tmp_path):
        env = nvidia_env(tmp_path)
        env.state.prepare(ts_claim(PORT, "t", "chip-4", "Short"))
        assert env.state.timeslicing.current_policy(4) == 1
        edits = claim_spec(env, "uid-t")["devices"][0]["containerEdits"]
        assert edits["env"] == [
            f"CUDA_VISIBLE_DEVICES={PORT.discovery.H100_PROBE[0].uuid}",
            "TPU_RUNTIME_PREEMPTION_MS=1",
            "TPU_TIMESHARE_DIR=/var/run/tpu-timeshare"]
        assert edits["mounts"] == [{
            "hostPath": str(tmp_path / "plugin" / "timeshare"),
            "containerPath": "/var/run/tpu-timeshare",
            "options": ["rw", "bind"]}]
        assert all_specs_valid(env) == 2
        env.state.unprepare("uid-t")
        assert env.state.timeslicing.current_policy(4) == 0
        assert all_specs_valid(env) == 1

    def test_restart_keeps_the_card_claim(self, tmp_path):
        env = nvidia_env(tmp_path)
        first = env.state.prepare(make_allocated_claim(
            PORT, "r", [("r0", "chip-4")])).to_json()
        again = PORT.plugin.DeviceState(
            env.host.materialize(env.tree), env.cluster, env.state.config)
        assert again.prepared["uid-r"].to_json() == first
        again.unprepare("uid-r")
        assert again.prepared == {} and all_specs_valid(env) == 1

    def test_spec_path_is_the_card_node_on_the_tree(self, tmp_path):
        """Every device node and mount host path of the standard spec
        exists on the host (the driver root)."""
        env = nvidia_env(tmp_path, form="driver")
        spec = standard(env)
        nodes = [n["path"] for d in spec["devices"]
                 for n in d["containerEdits"].get("deviceNodes", [])]
        nodes += [n["path"] for n in spec["containerEdits"]["deviceNodes"]]
        for path in nodes:
            assert (env.tree / path.lstrip("/")).exists(), path
        for m in spec["containerEdits"]["mounts"]:
            assert Path(m["hostPath"]).exists(), m

    def test_tpu_host_keeps_the_reference_contract(self, tmp_path):
        """The same port code on a TPU tree writes no NVIDIA edit."""
        env = make_env(PORT, tmp_path)
        env.state.prepare(make_allocated_claim(PORT, "x",
                                               [("r0", "chip-0")]))
        text = "".join(p.read_text()
                       for p in (tmp_path / "cdi").glob("*.json"))
        assert "NVIDIA" not in text and "CUDA_VISIBLE" not in text
        assert "/dev/nvidia" not in text


def test_h100_unhealthy_card_refused_with_reason(tmp_path):
    """A card whose node vanished leaves the allocatable set, and a
    claim already allocated on it is refused with the reason."""
    env = nvidia_env(tmp_path)
    (env.tree / "dev/nvidia6").unlink()
    unhealthy = PORT.discovery.SysfsBackend(
        host_root=str(env.tree), env=env.host.env(),
        hostname="gpu-host-0").health(expected={4, 6})
    assert set(unhealthy) == {6}
    assert env.state.apply_health(unhealthy)
    assert not any(n.startswith("chip-6") for n in env.state.allocatable)
    with pytest.raises(PORT.plugin.PrepareError) as err:
        env.state.prepare(make_allocated_claim(PORT, "u",
                                               [("r0", "chip-6")]))
    assert "unhealthy" in str(err.value) and unhealthy[6] in str(err.value)
