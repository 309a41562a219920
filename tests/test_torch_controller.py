"""The port's slice-gang controller (the twin of tests/test_controller.py):
the label watch, ref-counting, channel carving, per-slice pools,
cleanup and retry; the pools published for a sequence of Node events
equal the JAX controller's; an NVIDIA node (no slice label) gets none;
and ``cmd/controller.py``'s ``run`` over a cluster."""

import threading
import time

import pytest

from k8s_dra_driver_tpu.cluster import FakeCluster as JaxCluster
from k8s_dra_driver_tpu.controller import \
    SliceGangController as JaxController
from k8s_dra_driver_tpu_torch.api import resource
from k8s_dra_driver_tpu_torch.cluster import FakeCluster, Node
from k8s_dra_driver_tpu_torch.cmd import controller as controller_cmd
from k8s_dra_driver_tpu_torch.controller import (ChannelOffsets, SLICE_LABEL,
                                                 SliceGangController,
                                                 parse_slice_label,
                                                 slice_label_value)

from torch_driver import BOTH, JAX, PORT, as_dict


def make_node(name, slice_value=None, pkg=PORT):
    labels = {SLICE_LABEL: slice_value} if slice_value else {}
    r = pkg.resource
    return pkg.cluster.Node(metadata=r.ObjectMeta(name=name, labels=labels))


@pytest.fixture
def rig():
    cluster = FakeCluster()
    ctrl = SliceGangController(cluster, channels_per_slice=8,
                               retry_delay_s=0.01)
    ctrl.start()
    yield cluster, ctrl
    ctrl.stop()


class TestChannelOffsets:
    def test_carving_and_reuse(self):
        offs = ChannelOffsets(total=32, per_slice=8)
        assert offs.add("a") == 0
        assert offs.add("b") == 8
        assert offs.add("a") == 0
        offs.remove("a")
        assert offs.add("c") == 0
        assert offs.add("d") == 16

    def test_exhaustion(self):
        offs = ChannelOffsets(total=16, per_slice=8)
        offs.add("a")
        offs.add("b")
        with pytest.raises(RuntimeError, match="exhausted"):
            offs.add("c")


class TestParseLabel:
    def test_roundtrip(self):
        assert parse_slice_label("slice-a.4x4") == ("slice-a", "4x4")
        assert parse_slice_label("proj.zone.s1.2x2") == ("proj.zone.s1", "2x2")
        assert slice_label_value("slice-a", "4x4") == "slice-a.4x4"

    def test_rejects(self):
        for bad in ("", "noslice", "4x4", "id."):
            with pytest.raises(ValueError):
                parse_slice_label(bad)


class TestController:
    def test_slice_appears_with_labeled_node(self, rig):
        cluster, ctrl = rig
        cluster.create(make_node("w0", "slice-a.4x4"))
        assert ctrl.active_slices() == {"slice-a.4x4": {"w0"}}
        slices = cluster.list("ResourceSlice")
        assert len(slices) == 1
        s = slices[0]
        assert s.node_selector == {SLICE_LABEL: "slice-a.4x4"}
        names = {d.name for d in s.devices}
        assert "podslice" in names
        assert "channel-0" in names and "channel-7" in names
        pod = next(d for d in s.devices if d.name == "podslice")
        assert pod.attributes["sliceTopology"] == "4x4"

    def test_refcounting_until_last_node(self, rig):
        cluster, ctrl = rig
        cluster.create(make_node("w0", "slice-a.4x4"))
        cluster.create(make_node("w1", "slice-a.4x4"))
        assert len(cluster.list("ResourceSlice")) == 1
        cluster.delete("Node", "", "w0")
        assert len(cluster.list("ResourceSlice")) == 1
        cluster.delete("Node", "", "w1")
        assert cluster.list("ResourceSlice") == []
        assert ctrl.active_slices() == {}

    def test_two_slices_get_disjoint_channels(self, rig):
        cluster, ctrl = rig
        cluster.create(make_node("a0", "slice-a.2x2"))
        cluster.create(make_node("b0", "slice-b.2x2"))
        slices = cluster.list("ResourceSlice")
        assert len(slices) == 2
        ids = [sorted(d.attributes["channelId"] for d in s.devices
                      if d.attributes.get("type") == "rendezvous")
               for s in slices]
        assert set(ids[0]).isdisjoint(ids[1])

    def test_node_relabel_moves_slice(self, rig):
        cluster, ctrl = rig
        node = cluster.create(make_node("w0", "slice-a.2x2"))
        node.metadata.labels[SLICE_LABEL] = "slice-b.2x2"
        cluster.update(node)
        assert ctrl.active_slices() == {"slice-b.2x2": {"w0"}}
        slices = cluster.list("ResourceSlice")
        assert len(slices) == 1
        assert slices[0].node_selector == {SLICE_LABEL: "slice-b.2x2"}

    def test_stop_cleans_up(self, rig):
        cluster, ctrl = rig
        cluster.create(make_node("w0", "slice-a.2x2"))
        assert len(cluster.list("ResourceSlice")) == 1
        ctrl.stop()
        assert cluster.list("ResourceSlice") == []

    def test_unlabeled_nodes_ignored(self, rig):
        cluster, ctrl = rig
        cluster.create(make_node("plain"))
        assert ctrl.active_slices() == {}
        assert cluster.list("ResourceSlice") == []

    def test_transient_error_retried(self, rig):
        cluster, ctrl = rig
        fails = {"n": 2}
        original = ctrl.publisher.publish

        def flaky(pools):
            if fails["n"] > 0:
                fails["n"] -= 1
                raise RuntimeError("api server unavailable")
            return original(pools)
        ctrl.publisher.publish = flaky
        cluster.create(make_node("w0", "slice-a.2x2"))
        deadline = time.time() + 2
        while time.time() < deadline and not cluster.list("ResourceSlice"):
            time.sleep(0.01)
        assert len(cluster.list("ResourceSlice")) == 1


#: (verb, node, label value or None): create, relabel, delete
EVENTS = [
    ("create", "a0", "slice-a.4x4"), ("create", "a1", "slice-a.4x4"),
    ("create", "gpu", None), ("create", "b0", "proj.zone.b.2x2"),
    ("relabel", "a1", "slice-c.2x1"), ("create", "c1", "slice-c.2x1"),
    ("delete", "a0", None), ("relabel", "b0", None),
    ("create", "d0", "slice-d.2x2"), ("relabel", "gpu", "slice-a.4x4"),
]


def published(cluster):
    return sorted((as_dict(s) for s in cluster.list("ResourceSlice")),
                  key=lambda s: s["metadata"]["name"])


def strip_volatile(slices):
    for s in slices:
        for key in ("uid", "resource_version", "creation_timestamp"):
            s["metadata"].pop(key, None)
    return slices


class TestPoolsEqualJax:
    """Both controllers over their own cluster, fed the same Node
    events: after each event the published ResourceSlices are equal."""

    def test_same_events_same_pools(self):
        rigs = {}
        for pkg, cluster_cls, ctrl_cls in ((JAX, JaxCluster, JaxController),
                                           (PORT, FakeCluster,
                                            SliceGangController)):
            cluster = cluster_cls()
            ctrl = ctrl_cls(cluster, channels_per_slice=16,
                            retry_delay_s=0.01)
            ctrl.start()
            rigs[pkg.name] = (pkg, cluster, ctrl)
        try:
            for verb, name, value in EVENTS:
                for pkg, cluster, _ in rigs.values():
                    if verb == "create":
                        cluster.create(make_node(name, value, pkg))
                    elif verb == "delete":
                        cluster.delete("Node", "", name)
                    else:
                        node = cluster.get("Node", "", name)
                        node.metadata.labels.pop(SLICE_LABEL, None)
                        if value:
                            node.metadata.labels[SLICE_LABEL] = value
                        cluster.update(node)
                jax_pools, port_pools = (
                    strip_volatile(published(c)) for _, c, _ in
                    rigs.values())
                assert port_pools == jax_pools, (verb, name, value)
            assert {p["pool"]["name"] for p in port_pools} == {
                "slice-slice-a-4x4", "slice-slice-c-2x1", "slice-slice-d-2x2"}
            assert rigs[PORT.name][2].active_slices() == \
                rigs[JAX.name][2].active_slices()
        finally:
            for _, cluster, ctrl in rigs.values():
                ctrl.stop()
        for _, cluster, _ in rigs.values():
            assert cluster.list("ResourceSlice") == []

    def test_nvidia_node_gets_no_pool(self, rig):
        """An H100 host's plugin sets no slice label: the controller
        publishes nothing for its node (as the JAX controller)."""
        cluster, ctrl = rig
        cluster.create(Node(metadata=resource.ObjectMeta(
            name="h100-node", labels={"kubernetes.io/hostname": "h100"})))
        assert ctrl.active_slices() == {}
        assert cluster.list("ResourceSlice") == []


def run_controller(argv, cluster):
    args = controller_cmd.build_parser().parse_args(argv)
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=controller_cmd.run, args=(args,),
                         kwargs=dict(client=cluster, ready_event=ready,
                                     stop_event=stop), daemon=True)
    t.start()
    assert ready.wait(10)
    return t, stop


class TestControllerCommand:
    @pytest.fixture(autouse=True)
    def keep_logging(self, monkeypatch):
        import logging
        root = logging.getLogger()
        saved = root.handlers[:], root.level
        yield
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])

    def test_run_publishes_and_cleans_up(self):
        cluster = FakeCluster()
        cluster.create(make_node("w0", "slice-a.2x2"))
        t, stop = run_controller(["--device-classes", "podslice",
                                  "--channels-per-slice", "4"], cluster)
        try:
            (s,) = cluster.list("ResourceSlice")
            assert sorted(d.name for d in s.devices) == [
                "channel-0", "channel-1", "channel-2", "channel-3",
                "podslice"]
        finally:
            stop.set()
            t.join(timeout=10)
        assert not t.is_alive()
        assert cluster.list("ResourceSlice") == []

    def test_gang_manager_needs_podslice(self):
        cluster = FakeCluster()
        cluster.create(make_node("w0", "slice-a.2x2"))
        t, stop = run_controller(["--device-classes", "chip,core"],
                                 cluster)
        stop.set()
        t.join(timeout=10)
        assert not t.is_alive()
        assert cluster.list("ResourceSlice") == []

    @pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
    def test_owner_reference_from_own_pod(self, pkg):
        r = pkg.resource
        cluster = pkg.cluster.FakeCluster()
        cluster.create(pkg.cluster.Pod(metadata=r.ObjectMeta(
            name="ctl-0", namespace="tpu-dra-driver", uid="uid-ctl")))
        ctl = __import__(f"{pkg.name}.cmd.controller",
                         fromlist=["_owner_reference"])
        ref = ctl._owner_reference(cluster, "tpu-dra-driver", "ctl-0")
        assert (ref.kind, ref.name, ref.uid) == ("Pod", "ctl-0", "uid-ctl")
        assert ctl._owner_reference(cluster, "tpu-dra-driver", "") is None
        assert ctl._owner_reference(cluster, "tpu-dra-driver",
                                    "missing") is None
