"""The port's kubelet-plugin gRPC services against the JAX package's (the
twin of tests/test_driver_grpc.py): a fake kubelet drives both
packages' real servers over real unix-domain sockets (registration,
prepare and unprepare, in-band errors, publication) and the answers are
compared.  The port's serialized descriptors are the JAX package's byte
for byte, both packages' proto modules import in one process, and each
package's stubs talk to the other's servers."""

import shutil
import sys
from pathlib import Path

import grpc
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_driver import BOTH, JAX, PORT  # noqa: E402
from torch_plugin import make_allocated_claim, short_dir  # noqa: E402


def start_driver(pkg, root):
    backend = pkg.discovery.FakeHost().materialize(root / "host")
    cluster = pkg.cluster.FakeCluster()
    state = pkg.plugin.DeviceState(backend, cluster,
                                   pkg.plugin.DeviceStateConfig(
                                       plugin_root=str(root / "plugin"),
                                       cdi_root=str(root / "cdi"),
                                       node_name="tpu-host-0",
                                       coordinator_image="registry.local/"
                                                         "tpu-dra-driver:test"))
    driver = pkg.plugin.Driver(state, cluster,
                               plugin_dir=str(root / "plugin"))
    driver.start()
    return driver, cluster


@pytest.fixture
def rigs():
    root = short_dir("tgrpc-")
    out = {pkg.name: start_driver(pkg, root / pkg.name[-5:])
           for pkg in BOTH}
    yield out
    for driver, _ in out.values():
        driver.shutdown()
    shutil.rmtree(root, ignore_errors=True)


def dra_stub(stub_pkg, driver):
    return stub_pkg.proto.DRAPluginStub(
        grpc.insecure_channel(f"unix://{driver.plugin_socket}"))


def claim_ref(pkg, uid, name):
    return pkg.proto.dra_pb2.Claim(uid=uid, namespace="default", name=name)


def prepare(pkg, driver, uid, name, stub_pkg=None):
    stub_pkg = stub_pkg or pkg
    return dra_stub(stub_pkg, driver).NodePrepareResources(
        stub_pkg.proto.dra_pb2.NodePrepareResourcesRequest(
            claims=[claim_ref(stub_pkg, uid, name)]))


def both(rigs, fn):
    return fn(JAX, *rigs[JAX.name]), fn(PORT, *rigs[PORT.name])


class TestRegistration:
    def test_get_info_and_notify(self, rigs):
        def run(pkg, driver, _):
            stub = pkg.proto.RegistrationStub(
                grpc.insecure_channel(f"unix://{driver.registrar_socket}"))
            info = stub.GetInfo(pkg.proto.registration_pb2.InfoRequest())
            stub.NotifyRegistrationStatus(
                pkg.proto.registration_pb2.RegistrationStatus(
                    plugin_registered=True))
            assert driver.registrar.registered.is_set()
            return (info.name, info.type, list(info.supported_versions),
                    info.endpoint == str(driver.plugin_socket),
                    driver.registrar_socket.name)
        ij, ip = both(rigs, run)
        assert ip == ij
        assert ip[:2] == ("tpu.google.com", "DRAPlugin")
        assert "v1alpha3" in ip[2] and ip[3]


class TestPublication:
    def test_node_slice_published_on_start(self, rigs):
        def run(pkg, _, cluster):
            (s,) = cluster.list("ResourceSlice")
            return (s.metadata.name, s.driver, s.node_name,
                    [d.name for d in s.devices],
                    s.pool.generation)
        sj, sp = both(rigs, run)
        assert sp == sj
        assert sp[1] == "tpu.google.com" and sp[2] == "tpu-host-0"
        assert "chip-0" in sp[3] and "slice-2x2-at-0-0-0" in sp[3]

    def test_republish_is_stable(self, rigs):
        def run(pkg, driver, cluster):
            rv = cluster.list("ResourceSlice")[0].metadata.resource_version
            driver.publish_resources()
            return cluster.list(
                "ResourceSlice")[0].metadata.resource_version == rv
        assert both(rigs, run) == (True, True)


class TestPrepareOverGrpc:
    def test_prepare_and_unprepare(self, rigs):
        def run(pkg, driver, cluster):
            claim = make_allocated_claim(pkg, "c1", [("r0", "chip-0")])
            cluster.create(claim)
            resp = prepare(pkg, driver, "uid-c1", "c1")
            result = resp.claims["uid-c1"]
            unresp = dra_stub(pkg, driver).NodeUnprepareResources(
                pkg.proto.dra_pb2.NodeUnprepareResourcesRequest(
                    claims=[claim_ref(pkg, "uid-c1", "c1")]))
            return (resp.SerializeToString(deterministic=True),
                    result.error, [d.device_name for d in result.devices],
                    list(result.devices[0].cdi_device_ids),
                    unresp.claims["uid-c1"].error,
                    "uid-c1" in driver.state.prepared)
        rj, rp = both(rigs, run)
        assert rp == rj
        assert rp[1:] == ("", ["chip-0"], ["tpu.google.com/chip=chip-0",
                                           "tpu.google.com/claim=uid-c1"],
                          "", False)

    def test_missing_claim_in_band_error(self, rigs):
        ej, ep = both(rigs, lambda pkg, d, _: prepare(
            pkg, d, "uid-x", "ghost").claims["uid-x"].error)
        assert ep == ej and "not found" in ep

    def test_uid_mismatch_rejected(self, rigs):
        def run(pkg, driver, cluster):
            cluster.create(make_allocated_claim(pkg, "c1",
                                                [("r0", "chip-0")]))
            return prepare(pkg, driver, "uid-stale",
                           "c1").claims["uid-stale"].error
        ej, ep = both(rigs, run)
        assert ep == ej and "UID mismatch" in ep

    def test_metrics_observed(self, rigs):
        def run(pkg, driver, cluster):
            cluster.create(make_allocated_claim(pkg, "c1",
                                                [("r0", "chip-1")]))
            prepare(pkg, driver, "uid-c1", "c1")
            text = driver.metrics.render().decode()
            return ('tpu_dra_prepare_seconds_count{outcome="ok"} 1.0'
                    in text, "tpu_dra_prepared_claims 1.0" in text,
                    "tpu_dra_published_devices 13.0" in text)
        assert both(rigs, run) == ((True,) * 3, (True,) * 3)


class TestWireContract:
    @pytest.mark.parametrize("module", ["dra_pb2", "registration_pb2"])
    def test_serialized_descriptors_are_byte_identical(self, module):
        jax_mod = getattr(JAX.proto, module)
        port_mod = getattr(PORT.proto, module)
        assert port_mod.DESCRIPTOR.serialized_pb == \
            jax_mod.DESCRIPTOR.serialized_pb
        assert port_mod.DESCRIPTOR.name == jax_mod.DESCRIPTOR.name
        src = Path(port_mod.__file__).read_text()
        assert src == Path(jax_mod.__file__).read_text()

    def test_service_names_and_paths(self):
        for name in ("DRA_SERVICE", "REGISTRATION_SERVICE"):
            assert getattr(PORT.services, name) == \
                getattr(JAX.services, name)
        assert PORT.services.DRA_SERVICE == "v1alpha3.DRAPlugin"

    @pytest.mark.parametrize("stub_pkg,server_pkg",
                             [(PORT, JAX), (JAX, PORT)],
                             ids=["port-stub-jax-server",
                                  "jax-stub-port-server"])
    def test_stub_talks_to_the_other_server(self, rigs, stub_pkg,
                                            server_pkg):
        driver, cluster = rigs[server_pkg.name]
        cluster.create(make_allocated_claim(server_pkg, "x",
                                            [("r0", "chip-3")]))
        resp = prepare(server_pkg, driver, "uid-x", "x", stub_pkg=stub_pkg)
        result = resp.claims["uid-x"]
        assert result.error == ""
        assert [d.device_name for d in result.devices] == ["chip-3"]
        info = stub_pkg.proto.RegistrationStub(grpc.insecure_channel(
            f"unix://{driver.registrar_socket}")).GetInfo(
                stub_pkg.proto.registration_pb2.InfoRequest())
        assert info.name == "tpu.google.com"
        unresp = dra_stub(stub_pkg, driver).NodeUnprepareResources(
            stub_pkg.proto.dra_pb2.NodeUnprepareResourcesRequest(
                claims=[claim_ref(stub_pkg, "uid-x", "x")]))
        assert unresp.claims["uid-x"].error == ""
        assert driver.state.prepared == {}
