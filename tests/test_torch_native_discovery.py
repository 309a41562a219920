"""The port's C++ discovery shim (k8s_dra_driver_tpu_torch/native/
tpudiscovery.cc) against its Python backend and against the JAX
package's: tests/test_native_discovery.py's scenarios on fake TPU trees,
where all three must agree, then the NVIDIA path on fake trees built
from the probe of the H100's machine, where the port's two backends must
agree field by field."""

import ctypes
import shutil

import pytest

from torch_driver import JAX, PORT, as_dict

P = PORT.discovery
J = JAX.discovery
native = PORT.native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")


@pytest.fixture(scope="module")
def lib():
    return native.ensure_built()


def all_three(root, env, hostname):
    """JAX's SysfsBackend, the port's SysfsBackend and the port's shim
    over one tree; returns the shim's topology."""
    jt = J.SysfsBackend(host_root=str(root), env=env,
                        hostname=hostname).enumerate()
    pt = P.SysfsBackend(host_root=str(root), env=env,
                        hostname=hostname).enumerate()
    cc = native.NativeBackend(host_root=str(root), env=env,
                              hostname=hostname).enumerate()
    assert cc == pt, f"shim:\n {cc}\npython:\n {pt}"
    assert as_dict(cc) == as_dict(jt)
    return cc


def tpu(tmp_path, **kw):
    host = P.FakeHost(**kw)
    host.materialize(tmp_path)
    return all_three(tmp_path, host.env(), host.hostname)


def test_builds_from_the_ports_source_into_build_native(lib):
    nb = PORT.native.nativebuild
    assert lib == nb.BUILD_DIR / "libtpudiscovery.so" and lib.is_file()
    assert nb.BUILD_DIR.parts[-2:] == ("build", "native")
    assert nb.NATIVE_DIR.parent.name == "k8s_dra_driver_tpu_torch"
    assert (nb.NATIVE_DIR / "tpudiscovery.cc").is_file()


def test_version_symbol(lib):
    handle = ctypes.CDLL(str(lib))
    handle.tpu_discover_version.restype = ctypes.c_char_p
    assert handle.tpu_discover_version().decode().startswith("tpudiscovery/")


class TestTpuTrees:
    def test_single_host_v5e(self, tmp_path, lib):
        assert len(tpu(tmp_path, hostname="n0").chips) == 4

    def test_multicore_v5p(self, tmp_path, lib):
        assert tpu(tmp_path, generation="v5p",
                   hostname="p0").chips[0].cores == 2

    def test_slice_worker_offsets(self, tmp_path, lib):
        cc = tpu(tmp_path, hostname="w2", num_chips=4, slice_id="s-a",
                 topology="4x4", worker_id=2,
                 worker_hostnames=("w0", "w1", "w2", "w3"))
        assert cc.slice.worker_id == 2
        assert cc.chips[0].coord.as_tuple() == (0, 2, 0)

    def test_serialless_uuid_sha_fallback(self, tmp_path, lib):
        cc = tpu(tmp_path, hostname="h", with_serials=False)
        assert cc.chips[0].uuid.startswith("TPU-v5e-")

    def test_no_libtpu(self, tmp_path, lib):
        assert tpu(tmp_path, with_libtpu=False).libtpu_path == ""

    def test_foreign_vendor_filtered(self, tmp_path, lib):
        host = P.FakeHost(hostname="n0", num_chips=2)
        host.materialize(tmp_path)
        pci = tmp_path / "sys/devices/0000:99:00.0"
        pci.mkdir(parents=True)
        (pci / "vendor").write_text("0x10de\n")
        (pci / "device").write_text("0x2330\n")
        link = tmp_path / "sys/class/accel/accel7/device"
        link.parent.mkdir(parents=True)
        link.symlink_to(pci)
        cc = all_three(tmp_path, host.env(), host.hostname)
        assert len(cc.chips) == 2

    def test_env_fallback_generation(self, tmp_path, lib):
        host = P.FakeHost(hostname="n0", num_chips=1)
        host.materialize(tmp_path)
        (tmp_path / "sys/devices/0000:00:00.0/device").write_text("0xbeef\n")
        cc = all_three(tmp_path, host.env(), host.hostname)
        assert cc.chips[0].generation.name == "v5e"

    @pytest.mark.parametrize("gen", ["v4", "v6e"])
    def test_other_generations(self, tmp_path, lib, gen):
        assert tpu(tmp_path, generation=gen).generation.name == gen

    def test_non_chip_accel_entries_skipped(self, tmp_path, lib):
        """An accel-class entry whose suffix is not a number
        ("accel0_vfio") is no chip: the port's shim skips it as both
        Python backends do (the JAX package's shim reads it as chip 0
        a second time)."""
        host = P.FakeHost(hostname="n0", num_chips=2)
        host.materialize(tmp_path)
        link = tmp_path / "sys/class/accel/accel0_vfio/device"
        link.parent.mkdir(parents=True)
        link.symlink_to(tmp_path / "sys/devices/0000:00:00.0")
        cc = all_three(tmp_path, host.env(), host.hostname)
        assert [c.index for c in cc.chips] == [0, 1]
        jcc = JAX.native.NativeBackend(host_root=str(tmp_path),
                                       env=host.env(),
                                       hostname=host.hostname).enumerate()
        assert [c.index for c in jcc.chips] == [0, 0, 1]

    def test_empty_host(self, tmp_path, lib):
        assert all_three(tmp_path, {}, "h").chips == ()


# -- NVIDIA ---------------------------------------------------------------

FORMS = ["procfs", "driver"]


def both(root, hostname="g0"):
    """The port's Python backend and its shim over one NVIDIA tree,
    equal field by field; returns the shim's topology."""
    py = P.SysfsBackend(host_root=str(root), env={},
                        hostname=hostname).enumerate()
    cc = native.NativeBackend(host_root=str(root), env={},
                              hostname=hostname).enumerate()
    assert as_dict(cc) == as_dict(py)
    return cc


def h100(tmp_path, form, n=1, **kw):
    host = P.FakeHost(generation="h100", num_chips=n, hostname="g0",
                      nvidia=form, **kw)
    host.materialize(tmp_path)
    return host


class TestNvidiaTrees:
    @pytest.mark.parametrize("form", FORMS)
    def test_one_card(self, tmp_path, lib, form):
        h100(tmp_path, form)
        (chip,) = both(tmp_path).chips
        assert (chip.index, chip.uuid, chip.pci_address) == (
            4, P.H100_PROBE[0].uuid, "0000:9b:00.0")

    @pytest.mark.parametrize("form", FORMS)
    def test_the_other_probed_card(self, tmp_path, lib, form):
        h100(tmp_path, form, cards=P.H100_PROBE[1:])
        (chip,) = both(tmp_path).chips
        assert (chip.index, chip.uuid) == (6, P.H100_PROBE[1].uuid)

    @pytest.mark.parametrize("form", FORMS)
    def test_eight_cards(self, tmp_path, lib, form):
        h100(tmp_path, form, n=8)
        cc = both(tmp_path)
        assert [c.index for c in cc.chips] == list(range(8))

    def test_missing_information_file(self, tmp_path, lib):
        host = h100(tmp_path, "procfs", n=3)
        gone = host.nvidia_cards()[2]
        (tmp_path / "proc/driver/nvidia/gpus" / gone.bus_id
         / "information").unlink()
        assert len(both(tmp_path).chips) == 2

    def test_uuid_digest_rule(self, tmp_path, lib):
        """sha256(hostname/bus/minor): the C++ SHA-256 must match
        hashlib."""
        h100(tmp_path, "procfs", n=2, with_serials=False)
        assert all(c.uuid.startswith("GPU-h100-")
                   for c in both(tmp_path).chips)

    @pytest.mark.parametrize("form", FORMS)
    def test_vanished_device_node(self, tmp_path, lib, form):
        h100(tmp_path, form, n=2)
        (tmp_path / "dev/nvidia4").unlink()
        assert len(both(tmp_path).chips) == 2
        backend = native.NativeBackend(host_root=str(tmp_path), env={})
        assert backend.health(expected={4, 6}) == {
            4: "device node /dev/nvidia4 missing"}

    def test_mixed_host(self, tmp_path, lib):
        P.FakeHost(num_chips=2).materialize(tmp_path)
        h100(tmp_path, "procfs", n=2)
        errors = []
        for backend in (P.SysfsBackend(host_root=str(tmp_path), env={}),
                        native.NativeBackend(host_root=str(tmp_path),
                                             env={})):
            with pytest.raises(ValueError) as e:
                backend.enumerate()
            errors.append(str(e.value))
        assert errors[0] == errors[1]
        assert "[0, 1]" in errors[0] and "[4, 6]" in errors[0]

    def test_foreign_vendor(self, tmp_path, lib):
        h100(tmp_path, "procfs")
        for bus, vendor, cls in (("0000:01:00.0", "0x1ae0", "0x030200"),
                                 ("0000:02:00.0", "0x10de", "0x068000"),
                                 ("0000:03:00.0", "0x8086", "0x030000")):
            d = tmp_path / "sys/bus/pci/devices" / bus
            d.mkdir(parents=True)
            (d / "vendor").write_text(vendor + "\n")
            (d / "class").write_text(cls + "\n")
        assert [c.index for c in both(tmp_path).chips] == [4]

    def test_driver_form_without_library(self, tmp_path, lib):
        h100(tmp_path, "driver", with_libtpu=False)
        assert both(tmp_path).chips == ()
