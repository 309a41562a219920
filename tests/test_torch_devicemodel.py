"""The port's device model against the JAX package's
(tests/test_devicemodel.py's cases): on the same fake TPU tree both
packages' ``enumerate_host_devices`` give the same names and every
device's ``to_device()`` is equal field by field; then the H100's
devices from the probe's fake trees."""

import pytest

from torch_driver import JAX, PORT, as_dict, devices_of

P, J = PORT, JAX
GiB = 1024 ** 3


def topos(tmp_path, **kw):
    """The JAX package's and the port's topology of one fake tree."""
    host = J.discovery.FakeHost(**kw)
    host.materialize(tmp_path)
    mk = lambda pkg: pkg.discovery.SysfsBackend(
        host_root=str(tmp_path), env=host.env(),
        hostname=host.hostname).enumerate()
    return mk(J), mk(P)


def twin_devices(tmp_path, kinds=None, **kw):
    """Both packages' published devices, equal; returns the port's
    allocatable devices by name."""
    jt, pt = topos(tmp_path, **kw)
    got = [as_dict(d) for d in devices_of(P, pt, kinds)]
    want = [as_dict(d) for d in devices_of(J, jt, kinds)]
    assert got == want
    dm = P.devicemodel
    return (dm.enumerate_host_devices(pt) if kinds is None
            else dm.enumerate_host_devices(pt, kinds=kinds))


def shared_tokens(dev):
    return {k for k in dev.to_device().capacity
            if P.devicemodel.is_shared_token(k)}


@pytest.fixture
def v5e(tmp_path):
    return twin_devices(tmp_path)


@pytest.fixture
def v5p(tmp_path):
    return twin_devices(tmp_path, generation="v5p")


class TestEnumeration:
    def test_v5e_host_inventory(self, v5e):
        assert "slice-2x2-at-0-0-0" in v5e
        assert len(v5e) == 4 + 4 + 2 + 2 + 1

    def test_v5p_has_two_cores_per_chip(self, v5p):
        assert v5p["chip-0-core-0"].hbm_bytes == v5p["chip-0"].hbm_bytes // 2

    @pytest.mark.parametrize("gen", ["v4", "v6e"])
    def test_other_generations(self, tmp_path, gen):
        assert twin_devices(tmp_path, generation=gen)

    @pytest.mark.parametrize("kinds", [("chip",), ("core",), ("slice",),
                                       ("chip", "slice")])
    def test_kind_gating(self, tmp_path, kinds):
        devs = twin_devices(tmp_path, kinds=kinds)
        assert {d.kind for d in devs.values()} == set(kinds)

    def test_rendezvous_and_podslice_names(self):
        dm = P.devicemodel
        assert dm.AllocatableDevice(dm.KIND_RENDEZVOUS, (),
                                    channel_id=3).name == "channel-3"
        rdv = dm.AllocatableDevice(dm.KIND_RENDEZVOUS, (), channel_id=3,
                                   slice_id="s").to_device()
        jdm = J.devicemodel
        jrdv = jdm.AllocatableDevice(jdm.KIND_RENDEZVOUS, (), channel_id=3,
                                     slice_id="s").to_device()
        assert as_dict(rdv) == as_dict(jrdv)
        assert dm.ALL_DEVICE_KINDS == jdm.ALL_DEVICE_KINDS


class TestVocabulary:
    def test_chip_attributes(self, v5e):
        dev = v5e["chip-2"].to_device()
        a = dev.attributes
        assert a["productName"] == "tpu-v5-lite"
        assert (a["ici.x"], a["ici.y"]) == (0, 1)
        assert dev.capacity["hbm"] == 16 * GiB
        assert dev.capacity["slot.core.2.0"] == 1

    def test_slice_attributes(self, v5e):
        dev = v5e["slice-2x2-at-0-0-0"].to_device()
        assert dev.attributes["numChips"] == 4
        assert dev.capacity["hbm"] == 64 * GiB

    def test_core_parent_uuid_constraint_surface(self, v5p):
        c0 = v5p["chip-1-core-0"].to_device().attributes
        c1 = v5p["chip-1-core-1"].to_device().attributes
        assert c0["parentUUID"] == c1["parentUUID"]
        assert c0["uuid"] != c1["uuid"]


class TestOverlapTokens:
    def test_chip_vs_its_core_collide(self, v5e):
        assert shared_tokens(v5e["chip-0"]) & shared_tokens(
            v5e["chip-0-core-0"])

    def test_disjoint_chips_dont_collide(self, v5e):
        assert not shared_tokens(v5e["chip-0"]) & shared_tokens(
            v5e["chip-1"])

    def test_slice_collides_with_member_chip_only(self, v5e):
        s = shared_tokens(v5e["slice-1x2-at-0-0-0"])
        assert s & shared_tokens(v5e["chip-2"])
        assert not s & shared_tokens(v5e["chip-1"])

    def test_overlapping_slices_collide(self, v5e):
        a = shared_tokens(v5e["slice-2x2-at-0-0-0"])
        for other in ("slice-1x2-at-0-0-0", "slice-2x1-at-0-0-0"):
            assert a & shared_tokens(v5e[other])

    def test_sibling_cores_dont_collide(self, v5p):
        assert not shared_tokens(v5p["chip-0-core-0"]) & shared_tokens(
            v5p["chip-0-core-1"])


class TestMultiHost:
    def test_worker_coords_are_absolute(self, tmp_path):
        host = J.discovery.fake_slice_hosts(4, topology="4x4")[3]
        devs = twin_devices(tmp_path, **{
            f: getattr(host, f) for f in (
                "generation", "num_chips", "hostname", "host_bounds",
                "slice_id", "topology", "worker_id", "worker_hostnames")})
        attrs = devs["chip-0"].to_device().attributes
        assert (attrs["ici.x"], attrs["ici.y"]) == (2, 2)
        assert attrs["sliceId"] == "slice-a"
        assert "slice-2x2-at-2-2-0" in devs


class TestPreparedRoundtrip:
    def make(self, pkg):
        dm = pkg.devicemodel
        return dm.PreparedClaim(
            claim_uid="uid-1", claim_namespace="ns", claim_name="c",
            devices=[dm.PreparedDevice(
                request="r0", kind="chip", device_name="chip-0",
                pool="host-a", uuids=["TPU-x"], chip_indices=[0],
                cdi_device_ids=["tpu.google.com/chip=chip-0"])],
            coordinator_ids=["coord-1"], timesliced_chips=[0])

    def test_json_roundtrip_across_packages(self):
        pc = self.make(P)
        assert pc.to_json() == self.make(J).to_json()
        assert P.devicemodel.PreparedClaim.from_json(pc.to_json()) == pc
        back = J.devicemodel.PreparedClaim.from_json(pc.to_json())
        assert as_dict(back) == as_dict(pc)

    def test_old_checkpoint_core_index_recovered(self):
        d = dict(request="r", kind="core", device_name="chip-3-core-1",
                 pool="p")
        assert P.devicemodel.PreparedDevice.from_json(d).core_index == 1
        assert (P.devicemodel.PreparedDevice.from_json(dict(d)).to_json()
                == J.devicemodel.PreparedDevice.from_json(dict(d)).to_json())


class TestH100:
    @pytest.mark.parametrize("form", ["procfs", "driver"])
    def test_one_card_publishes_a_chip_and_its_core(self, tmp_path, form):
        topo = P.discovery.FakeHost(generation="h100", num_chips=1,
                                    nvidia=form).materialize(
            tmp_path).enumerate()
        devs = P.devicemodel.enumerate_host_devices(topo)
        assert sorted(devs) == ["chip-4", "chip-4-core-0"]
        chip = devs["chip-4"].to_device()
        card = P.discovery.H100_PROBE[0]
        assert chip.attributes["uuid"] == card.uuid
        assert chip.attributes["productName"] == "nvidia-h100-80gb-hbm3"
        assert chip.attributes["generation"] == "h100"
        assert chip.attributes["index"] == 4
        assert chip.capacity["hbm"] == 81559 * 1024 ** 2
        core = devs["chip-4-core-0"].to_device()
        assert core.capacity["hbm"] == chip.capacity["hbm"]
        assert core.attributes["parentUUID"] == card.uuid
        assert shared_tokens(devs["chip-4"]) & shared_tokens(
            devs["chip-4-core-0"])

    def test_eight_cards_publish_pairs(self, tmp_path):
        topo = P.discovery.FakeHost(generation="h100", num_chips=8).\
            materialize(tmp_path).enumerate()
        devs = P.devicemodel.enumerate_host_devices(topo)
        slices = sorted(n for n, d in devs.items() if d.kind == "slice")
        assert slices == [f"slice-2x1-at-{x}-0-0" for x in (0, 2, 4, 6)]
        assert [c.index for c in devs["slice-2x1-at-2-0-0"].chips] == [2, 3]
        assert len(devs) == 8 + 8 + 4
