"""The port's discovery layer against the JAX package's
(tests/test_discovery.py's cases, each run through both packages and
compared: ``dataclasses.asdict`` of the two ``HostTopology``s on the same
fake TPU tree), then the NVIDIA path on fake trees built from the probe
of the H100's machine (``H100_PROBE``)."""

import hashlib
import os
from pathlib import Path

import pytest

from torch_driver import JAX, PORT, as_dict

P = PORT.discovery
J = JAX.discovery


def tree_files(root: Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*")):
        rel = p.relative_to(root).as_posix()
        if p.is_symlink():
            out[rel] = ("link", os.readlink(p).replace(str(root), ""))
        elif p.is_file():
            out[rel] = p.read_text()
    return out


def twin(root, env, hostname, **kw):
    """Both packages' SysfsBackend over one tree; their topologies must
    be equal field by field.  Returns the port's."""
    jt = J.SysfsBackend(host_root=str(root), env=env, hostname=hostname,
                        **kw).enumerate()
    pt = P.SysfsBackend(host_root=str(root), env=env, hostname=hostname,
                        **kw).enumerate()
    assert as_dict(pt) == as_dict(jt)
    return pt


def twin_host(tmp_path, **host_kw):
    """JAX's FakeHost writes the tree; both backends read it."""
    host = J.FakeHost(**host_kw)
    host.materialize(tmp_path)
    return twin(tmp_path, host.env(), host.hostname), host


class TestTopologyTable:
    def test_tpu_generations_are_the_jax_packages(self):
        for name, gen in J.GENERATIONS.items():
            assert as_dict(P.GENERATIONS[name]) == as_dict(gen)

    def test_h100_entry(self):
        gen = P.GENERATIONS["h100"]
        assert gen.product_name == "nvidia-h100-80gb-hbm3"
        assert gen.hbm_bytes_per_chip == 81559 * 1024 ** 2
        assert (gen.cores_per_chip, gen.ici_dims) == (1, 2)
        assert gen.default_host_bounds == (1, 1, 1)
        assert gen.pci_ids == ()

    @pytest.mark.parametrize("gen", ["v4", "v5e", "v5p", "v6e"])
    def test_port_fake_tree_equals_the_jax_one(self, tmp_path, gen):
        J.FakeHost(generation=gen).materialize(tmp_path / "j")
        P.FakeHost(generation=gen).materialize(tmp_path / "p")
        assert tree_files(tmp_path / "p") == tree_files(tmp_path / "j")


class TestMeshShape:
    def test_parse_roundtrip(self):
        for s in ("2x2", "4x4x4", "2x4"):
            assert str(P.MeshShape.parse(s)) == str(J.MeshShape.parse(s))
        assert P.MeshShape.parse("2x4").num_chips == 8

    @pytest.mark.parametrize("bad", ["", "x", "0x2", "1x2x3x4", "-1x2"])
    def test_parse_rejects(self, bad):
        for pkg in (J, P):
            with pytest.raises(ValueError):
                pkg.MeshShape.parse(bad)

    def test_placements_aligned(self):
        got = [c.as_tuple() for c in
               P.MeshShape(2, 2).placements(P.MeshShape(4, 4))]
        want = [c.as_tuple() for c in
                J.MeshShape(2, 2).placements(J.MeshShape(4, 4))]
        assert got == want == [(0, 0, 0), (0, 2, 0), (2, 0, 0), (2, 2, 0)]

    def test_placements_too_big(self):
        assert list(P.MeshShape(4, 4).placements(P.MeshShape(2, 2))) == []

    @pytest.mark.parametrize("gen,bounds", [
        ("v5e", (2, 2, 1)), ("v5e", (4, 4, 1)), ("v5p", (4, 4, 4)),
        ("v4", (2, 2, 1))])
    def test_standard_shapes(self, gen, bounds):
        got = P.standard_slice_shapes(P.GENERATIONS[gen],
                                      P.MeshShape(*bounds))
        want = J.standard_slice_shapes(J.GENERATIONS[gen],
                                       J.MeshShape(*bounds))
        assert [str(s) for s in got] == [str(s) for s in want]

    def test_h100_shapes_over_a_row_of_cards(self):
        gen = P.GENERATIONS["h100"]
        assert P.standard_slice_shapes(gen, P.MeshShape(1, 1, 1)) == []
        assert [str(s) for s in P.standard_slice_shapes(
            gen, P.MeshShape(8, 1, 1))] == ["2x1"]


class TestBoundsAndOrigins:
    def test_parse_bounds(self):
        for s in ("2,2,1", "4"):
            assert as_dict(P.parse_bounds(s)) == as_dict(J.parse_bounds(s))
        assert P.parse_bounds("4") == P.MeshShape(4, 1, 1)

    def test_host_origin_tiling(self):
        got = [P.host_origin(w, P.MeshShape(2, 2), P.MeshShape(4, 4))
               for w in range(4)]
        want = [J.host_origin(w, J.MeshShape(2, 2), J.MeshShape(4, 4))
                for w in range(4)]
        assert [c.as_tuple() for c in got] == [c.as_tuple() for c in want]


class TestSysfsBackend:
    def test_enumerates_chips(self, tmp_path):
        topo, _ = twin_host(tmp_path)
        assert len(topo.chips) == 4 and topo.generation.name == "v5e"
        assert topo.chips[0].dev_paths == ("/dev/accel0",)
        assert topo.chips[0].hbm_bytes == 16 * 1024 ** 3

    def test_uuids_stable_and_unique(self, tmp_path):
        a, _ = twin_host(tmp_path / "a")
        b, _ = twin_host(tmp_path / "b")
        assert len({c.uuid for c in a.chips}) == 4
        assert [c.uuid for c in a.chips] == [c.uuid for c in b.chips]

    def test_uuid_without_serial(self, tmp_path):
        topo, _ = twin_host(tmp_path, with_serials=False)
        assert all(c.uuid.startswith("TPU-v5e-") for c in topo.chips)

    @pytest.mark.parametrize("gen", ["v4", "v5p", "v6e"])
    def test_other_generations(self, tmp_path, gen):
        topo, _ = twin_host(tmp_path, generation=gen)
        assert topo.generation.name == gen

    def test_libtpu_found_and_absent(self, tmp_path):
        topo, _ = twin_host(tmp_path / "a")
        assert topo.libtpu_path == "/usr/lib/libtpu.so"
        topo, _ = twin_host(tmp_path / "b", with_libtpu=False)
        assert topo.libtpu_path == ""

    def test_empty_host(self, tmp_path):
        topo = twin(tmp_path, {}, "h")
        assert topo.chips == () and topo.generation is None

    def test_foreign_vendor_skipped(self, tmp_path):
        host = J.FakeHost(num_chips=2)
        host.materialize(tmp_path)
        (tmp_path / "sys/devices/0000:01:00.0/vendor").write_text("0x10de\n")
        (tmp_path / "sys/devices/0000:01:00.0/device").write_text("0xffff\n")
        topo = twin(tmp_path, host.env(), host.hostname)
        assert [c.index for c in topo.chips] == [0]

    def test_unknown_device_id_falls_back_to_env(self, tmp_path):
        host = J.FakeHost(num_chips=1)
        host.materialize(tmp_path)
        (tmp_path / "sys/devices/0000:00:00.0/device").write_text("0xbeef\n")
        assert len(twin(tmp_path, host.env(), host.hostname).chips) == 1

    def test_health_vanished_and_sysfs_attribute(self, tmp_path):
        host = J.FakeHost(num_chips=4)
        host.materialize(tmp_path)
        (tmp_path / "dev/accel1").unlink()
        (tmp_path / "sys/devices/0000:02:00.0/health").write_text("dead\n")
        (tmp_path / "sys/class/accel/accel3/device").unlink()
        (tmp_path / "sys/class/accel/accel3").rmdir()
        want = J.SysfsBackend(host_root=str(tmp_path)).health(
            expected={0, 1, 2, 3})
        got = P.SysfsBackend(host_root=str(tmp_path)).health(
            expected={0, 1, 2, 3})
        assert got == want and set(got) == {1, 2, 3}


class TestMultiHostSlice:
    def test_fake_slice_gang(self, tmp_path):
        topos = []
        for host in J.fake_slice_hosts(4, topology="4x4"):
            host.materialize(tmp_path / host.hostname)
            topos.append(twin(tmp_path / host.hostname, host.env(),
                              host.hostname))
        assert len({t.slice.slice_id for t in topos}) == 1
        assert topos[0].slice.coordinator_address == "slice-a-w0"
        coords = {c.coord.as_tuple() for t in topos for c in t.chips}
        assert coords == {(x, y, 0) for x in range(4) for y in range(4)}

    def test_worker3_origin(self, tmp_path):
        host = J.fake_slice_hosts(4, topology="4x4")[3]
        host.materialize(tmp_path)
        topo = twin(tmp_path, host.env(), host.hostname)
        assert topo.chips[0].coord.as_tuple() == (2, 2, 0)

    def test_port_fake_slice_hosts_equal_jax(self):
        for a, b in zip(P.fake_slice_hosts(4, topology="4x4"),
                        J.fake_slice_hosts(4, topology="4x4")):
            assert a.env() == b.env()

    @pytest.mark.parametrize("opt_in", [True, False])
    def test_env_file_gating(self, tmp_path, monkeypatch, opt_in):
        if opt_in:
            monkeypatch.setenv(P.sysfs.ENV_FILE_FLAG, "1")
        else:
            monkeypatch.delenv(P.sysfs.ENV_FILE_FLAG, raising=False)
        host = J.fake_slice_hosts(4, topology="4x4")[2]
        host.materialize(tmp_path)
        jt = J.SysfsBackend(host_root=str(tmp_path),
                            hostname="h").enumerate()
        pt = P.SysfsBackend(host_root=str(tmp_path),
                            hostname="h").enumerate()
        assert as_dict(pt) == as_dict(jt)
        assert (pt.slice is not None) == opt_in
        assert len(pt.chips) == 4


class TestVisibleChipMasking:
    def test_enumerate_filters_to_the_mask(self, tmp_path):
        host = J.FakeHost(num_chips=4)
        host.materialize(tmp_path)
        mk = lambda pkg: pkg.MaskedBackend(pkg.SysfsBackend(
            host_root=str(tmp_path), env=host.env(),
            hostname=host.hostname), frozenset({0, 2})).enumerate()
        assert as_dict(mk(P)) == as_dict(mk(J))
        assert [c.index for c in mk(P).chips] == [0, 2]

    def test_unknown_index_fails_fast(self, tmp_path):
        inner = P.FakeHost(num_chips=2).materialize(tmp_path)
        with pytest.raises(ValueError, match=r"\[7\] not on this host"):
            P.MaskedBackend(inner, frozenset({0, 7})).enumerate()
        with pytest.raises(ValueError, match=">= 1 chip"):
            P.MaskedBackend(inner, frozenset())

    def test_health_only_reports_visible_chips(self, tmp_path):
        topo = P.FakeHost(num_chips=4).materialize(tmp_path).enumerate()
        inner = P.StaticBackend(topo)
        inner.unhealthy = {1: "thermal trip", 3: "thermal trip"}
        masked = P.MaskedBackend(inner, frozenset({0, 1}))
        assert set(masked.health(expected=frozenset({0, 1}))) == {1}

    def test_parse_visible_chips_list_and_file(self, tmp_path):
        (tmp_path / "visible_chips").write_text("1,3\n")
        (tmp_path / "empty").write_text("\n")
        for value in ("", " 0,2 ", "@/visible_chips", "@/empty"):
            assert (P.parse_visible_chips(value, str(tmp_path))
                    == J.parse_visible_chips(value, str(tmp_path)))
        with pytest.raises(ValueError, match="comma list"):
            P.parse_visible_chips("0,x")

    def test_mask_over_nvidia_minors(self, tmp_path):
        inner = P.FakeHost(generation="h100", num_chips=2,
                           hostname="g0").materialize(tmp_path)
        topo = P.MaskedBackend(inner, frozenset({6})).enumerate()
        assert [c.index for c in topo.chips] == [6]
        with pytest.raises(ValueError, match=r"\[0\] not on this host"):
            P.MaskedBackend(inner, frozenset({0})).enumerate()


# -- NVIDIA ---------------------------------------------------------------

FORMS = ["procfs", "driver"]


def h100(tmp_path, form, n=1, **kw):
    host = P.FakeHost(generation="h100", num_chips=n, hostname="g0",
                      nvidia=form, **kw)
    return host.materialize(tmp_path), host


class TestNvidia:
    @pytest.mark.parametrize("form", FORMS)
    def test_one_card_is_the_probed_card(self, tmp_path, form):
        backend, _ = h100(tmp_path, form)
        topo = backend.enumerate()
        card = P.H100_PROBE[0]
        (chip,) = topo.chips
        assert chip.index == card.minor == 4
        assert chip.uuid == card.uuid
        assert chip.pci_address == card.bus_id
        assert chip.dev_paths == ("/dev/nvidia4",)
        assert chip.coord.as_tuple() == (0, 0, 0)
        assert chip.generation.name == "h100" and chip.cores == 1
        assert topo.slice is None
        assert topo.host_bounds == P.MeshShape(1, 1, 1)
        assert topo.libtpu_path == "/usr/lib/x86_64-linux-gnu/libcuda.so.1"
        assert backend.health(expected={4}) == {}

    @pytest.mark.parametrize("form", FORMS)
    def test_eight_cards_in_minor_order(self, tmp_path, form):
        backend, host = h100(tmp_path, form, n=8)
        topo = backend.enumerate()
        minors = sorted(c.minor for c in host.nvidia_cards())
        assert [c.index for c in topo.chips] == minors == list(range(8))
        assert [c.coord.as_tuple() for c in topo.chips] == [
            (k, 0, 0) for k in range(8)]
        assert topo.host_bounds == P.MeshShape(8, 1, 1)
        by_minor = {c.minor: c for c in host.nvidia_cards()}
        for chip in topo.chips:
            assert chip.uuid == by_minor[chip.index].uuid
            assert chip.pci_address == by_minor[chip.index].bus_id

    def test_missing_information_skips_the_card(self, tmp_path):
        backend, host = h100(tmp_path, "procfs", n=2)
        gone = host.nvidia_cards()[1]
        (tmp_path / "proc/driver/nvidia/gpus" / gone.bus_id
         / "information").unlink()
        assert [c.index for c in backend.enumerate().chips] == [4]

    def test_information_without_uuid_takes_the_digest_rule(self, tmp_path):
        backend, _ = h100(tmp_path, "procfs", with_serials=False)
        (chip,) = backend.enumerate().chips
        digest = hashlib.sha256(b"g0/0000:9b:00.0/4").hexdigest()[:16]
        assert chip.uuid == f"GPU-h100-{digest}"

    def test_redacted_uuid_takes_the_digest_rule(self, tmp_path):
        backend, _ = h100(tmp_path, "procfs")
        info = (tmp_path / "proc/driver/nvidia/gpus/0000:9b:00.0"
                / "information")
        info.write_text(info.read_text().replace(P.H100_PROBE[0].uuid,
                                                 "GPU-REDACTED"))
        assert backend.enumerate().chips[0].uuid.startswith("GPU-h100-")

    @pytest.mark.parametrize("form", FORMS)
    def test_vanished_device_node(self, tmp_path, form):
        backend, _ = h100(tmp_path, form, n=2)
        (tmp_path / "dev/nvidia6").unlink()
        assert len(backend.enumerate().chips) == 2
        assert backend.health(expected={4, 6}) == {
            6: "device node /dev/nvidia6 missing"}

    def test_vanished_pci_device(self, tmp_path):
        backend, _ = h100(tmp_path, "procfs", n=2)
        for sub in ("sys/bus/pci/devices", "proc/driver/nvidia/gpus"):
            d = tmp_path / sub / "0000:cb:00.0"
            for f in d.iterdir():
                f.unlink()
            d.rmdir()
        assert backend.health(expected={4, 6}) == {
            6: "PCI device of /dev/nvidia6 vanished"}
        assert [c.index for c in backend.enumerate().chips] == [4]

    def test_mixed_host_is_refused(self, tmp_path):
        J.FakeHost(num_chips=2).materialize(tmp_path)
        backend, _ = h100(tmp_path, "procfs")
        with pytest.raises(ValueError, match=r"accel-class chips \[0, 1\] "
                           r"and NVIDIA cards \[4\]"):
            backend.enumerate()

    def test_foreign_vendor_and_non_display_skipped(self, tmp_path):
        backend, _ = h100(tmp_path, "procfs")
        for bus, vendor, cls in (("0000:01:00.0", "0x1ae0", "0x030200"),
                                 ("0000:02:00.0", "0x10de", "0x068000")):
            d = tmp_path / "sys/bus/pci/devices" / bus
            d.mkdir(parents=True)
            (d / "vendor").write_text(vendor + "\n")
            (d / "class").write_text(cls + "\n")
        assert [c.index for c in backend.enumerate().chips] == [4]

    @pytest.mark.parametrize("form", FORMS)
    def test_unknown_model_skipped(self, tmp_path, form):
        card = P.NvidiaCard(minor=0, uuid=P.H100_PROBE[0].uuid,
                            bus_id="0000:17:00.0", model="NVIDIA A100-SXM4-80GB")
        backend, _ = h100(tmp_path, form, cards=(card,))
        assert backend.enumerate().chips == ()

    def test_driver_form_without_library_has_no_cards(self, tmp_path):
        backend, _ = h100(tmp_path, "driver", with_libtpu=False)
        topo = backend.enumerate()
        assert topo.chips == () and topo.libtpu_path == ""

    def test_tpu_tree_shows_no_nvidia_health(self, tmp_path):
        backend = P.FakeHost(num_chips=2).materialize(tmp_path)
        assert backend.health(expected={0, 1}) == {}

    def test_names(self):
        assert P.sysfs.nvidia_product_name(
            "NVIDIA H100 80GB HBM3") == "nvidia-h100-80gb-hbm3"
        for raw in ("00000000:9B:00.0", "0000:9B:00.0", "0000:9b:00.0"):
            assert P.sysfs.normalize_bus_id(raw) == "0000:9b:00.0"


class TestProbe:
    def test_driver_form(self, tmp_path):
        from k8s_dra_driver_tpu_torch.discovery.probe import probe
        h100(tmp_path, "driver")
        got = probe(str(tmp_path))
        assert got["pci_nvidia"] == [] and got["procfs_gpus"] is None
        assert set(got["dev_nodes"]) == {
            "nvidia0", "nvidia4", "nvidiactl", "nvidia-uvm",
            "nvidia-uvm-tools"}
        assert got["libcuda"] == "/usr/lib/x86_64-linux-gnu/libcuda.so.1"
        assert got["nvml_beside_libcuda"] is True
        assert got["cards"] == [dict(minor=4, bus="0000:9b:00.0",
                                     name="NVIDIA H100 80GB HBM3")]
        assert got["nvml"]["init"] == 0
        assert got["nvml"]["cards"] == [
            {"index": 0, "uuid_rc": 0, "uuid_is_cudas": True}]

    def test_procfs_form(self, tmp_path):
        from k8s_dra_driver_tpu_torch.discovery.probe import probe
        h100(tmp_path, "procfs", n=2)
        got = probe(str(tmp_path))
        assert got["pci_nvidia"] == got["procfs_gpus"] == [
            "0000:9b:00.0", "0000:cb:00.0"]
        assert got["nvml_beside_libcuda"] is False and "cards" not in got

    def test_bare_host(self, tmp_path):
        from k8s_dra_driver_tpu_torch.discovery.probe import probe
        assert probe(str(tmp_path)) == {
            "pci_nvidia": [], "procfs_gpus": None, "dev_nodes": {},
            "libcuda": None}

    def test_tools(self):
        from k8s_dra_driver_tpu_torch.discovery.probe import tools
        got = tools()
        assert set(got) == {"g++", "grpc", "google.protobuf", "jsonschema",
                            "yaml", "prometheus_client"}
        assert got["g++"] is None or "g++" in got["g++"]
