"""The port's RestClusterClient against the JAX package's (the twin of
tests/test_rest_client.py): each scenario runs with both packages'
clients, each against its own MiniAPIServer, and what the server stored
(the wire format) and what the client decoded are compared, beside the
reference test's own assertions on the port."""

import dataclasses
import json
import os
import sys
import threading
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from miniapi import MiniAPIServer  # noqa: E402
from torch_driver import BOTH, JAX, PORT  # noqa: E402


def run_both(fn, **client_kw):
    """``fn(pkg, client, api)`` for each package on a fresh server:
    (JAX result, port result)."""
    out = []
    for pkg in BOTH:
        api = MiniAPIServer()
        api.start()
        client = pkg.rest.RestClusterClient(
            api.url, auth={}, **{"qps": 1000, "burst": 1000, **client_kw})
        try:
            out.append(fn(pkg, client, api))
        finally:
            client.close()
            api.stop()
    return tuple(out)


def stored(api):
    """The server's objects, with resourceVersions and uids dropped."""
    with api._lock:
        data = json.loads(json.dumps(api.objects))
    for obj in data.values():
        obj.get("metadata", {}).pop("resourceVersion", None)
        obj.get("metadata", {}).pop("uid", None)
    return data


def make_slice(pkg, name="s1", node="n1"):
    r = pkg.resource
    return r.ResourceSlice(
        metadata=r.ObjectMeta(name=name), driver="tpu.google.com",
        pool=r.ResourcePool(name="pool-a", generation=3), node_name=node,
        devices=[r.Device(
            name="chip-0",
            attributes={"type": "chip", "index": 0, "healthy": True,
                        "generation": "v5e"},
            capacity={"hbm": 16 << 30, "chipSlot0": 1})])


def as_dict(obj):
    return dataclasses.asdict(obj)


class TestCRUD:
    def test_resourceslice_roundtrip(self):
        def run(pkg, client, api):
            created = client.create(make_slice(pkg))
            got = client.get("ResourceSlice", "", "s1")
            got.metadata.resource_version = 0
            got.metadata.uid = ""
            return created.metadata.resource_version > 0, as_dict(got), \
                stored(api)
        rj, rp = run_both(run)
        assert rp == rj
        dev = rp[1]["devices"][0]
        assert dev["attributes"] == {"type": "chip", "index": 0,
                                     "healthy": True, "generation": "v5e"}
        assert dev["capacity"] == {"hbm": 16 << 30, "chipSlot0": 1}
        assert rp[1]["pool"]["generation"] == 3 and rp[0]

    def test_node_selector_roundtrip(self):
        def run(pkg, client, api):
            s = make_slice(pkg, name="gang")
            s.node_name = ""
            s.node_selector = {"tpu.google.com/slice": "slice-a.4x4"}
            client.create(s)
            return client.get("ResourceSlice", "", "gang").node_selector, \
                stored(api)
        rj, rp = run_both(run)
        assert rp == rj
        assert rp[0] == {"tpu.google.com/slice": "slice-a.4x4"}

    def test_conflict_and_not_found(self):
        def run(pkg, client, api):
            client.create(make_slice(pkg))
            errs = []
            for call in (lambda: client.create(make_slice(pkg)),
                         lambda: client.get("ResourceSlice", "", "missing"),
                         lambda: client.delete("ResourceSlice", "",
                                               "missing")):
                with pytest.raises((pkg.cluster.ConflictError,
                                    pkg.cluster.NotFoundError)) as err:
                    call()
                errs.append((type(err.value).__name__,
                             str(err.value).replace(api.url, "<API>")))
            return errs
        ej, ep = run_both(run)
        assert ep == ej
        assert [e[0] for e in ep] == ["ConflictError", "NotFoundError",
                                      "NotFoundError"]

    def test_apply_create_then_update(self):
        def run(pkg, client, api):
            client.apply(make_slice(pkg))
            s2 = make_slice(pkg)
            s2.devices[0].attributes["index"] = 7
            client.apply(s2)
            return client.get("ResourceSlice", "", "s1").devices[0] \
                .attributes["index"], stored(api)
        rj, rp = run_both(run)
        assert rp == rj and rp[0] == 7

    def test_update_fills_resource_version(self):
        def run(pkg, client, api):
            client.create(make_slice(pkg))
            fresh = make_slice(pkg)
            fresh.devices[0].attributes["index"] = 3
            return client.update(fresh).devices[0].attributes["index"]
        assert run_both(run) == (3, 3)

    def test_namespaced_deployment(self):
        def run(pkg, client, api):
            client.create(pkg.objects.Deployment(
                metadata=pkg.resource.ObjectMeta(name="coord",
                                                 namespace="tpu-ns"),
                spec={"replicas": 1, "template": {}}))
            got = client.get("Deployment", "tpu-ns", "coord")
            snap = stored(api)
            client.delete("Deployment", "tpu-ns", "coord")
            with pytest.raises(pkg.cluster.NotFoundError):
                client.get("Deployment", "tpu-ns", "coord")
            return got.spec, got.metadata.namespace, snap
        rj, rp = run_both(run)
        assert rp == rj
        assert rp[0]["replicas"] == 1 and rp[1] == "tpu-ns"

    def test_node_roundtrip(self):
        def run(pkg, client, api):
            api.objects["nodes//n1"] = {
                "metadata": {"name": "n1", "resourceVersion": "5",
                             "labels": {"a": "b"}},
                "status": {"conditions": [{"type": "Ready",
                                           "status": "True"}]}}
            node = client.get("Node", "", "n1")
            return node.ready, node.metadata.labels
        assert run_both(run) == ((True, {"a": "b"}),) * 2

    def test_node_update_preserves_unmodeled_fields(self):
        def run(pkg, client, api):
            api.objects["nodes//n1"] = {
                "metadata": {"name": "n1", "resourceVersion": "5",
                             "labels": {}, "annotations": {"keep": "me"}},
                "spec": {"podCIDR": "10.0.0.0/24"},
                "status": {"conditions": [{"type": "Ready",
                                           "status": "True"}]}}
            node = client.get("Node", "", "n1")
            node.metadata.labels["tpu.google.com/slice"] = "s.4x4"
            client.update(node)
            return stored(api)["nodes//n1"]
        nj, np_ = run_both(run)
        assert np_ == nj
        assert np_["spec"]["podCIDR"] == "10.0.0.0/24"
        assert np_["metadata"]["annotations"] == {"keep": "me"}
        assert np_["metadata"]["labels"] == {"tpu.google.com/slice": "s.4x4"}

    def test_claim_status_goes_through_subresource(self):
        def run(pkg, client, api):
            r = pkg.resource
            api.objects["resourceclaims/ns1/c1"] = {
                "metadata": {"name": "c1", "namespace": "ns1",
                             "uid": "u-1", "resourceVersion": "3"},
                "spec": {"devices": {"requests": [
                    {"name": "tpu", "deviceClassName": "tpu.google.com"}]}},
            }
            claim = client.get("ResourceClaim", "ns1", "c1")
            claim.status = r.ResourceClaimStatus(
                allocation=r.AllocationResult(
                    results=[r.DeviceRequestAllocationResult(
                        request="tpu", driver="tpu.google.com",
                        pool="n1", device="chip-0")],
                    node_selector={"kubernetes.io/hostname": "n1"}))
            client.update(claim)
            again = client.get("ResourceClaim", "ns1", "c1")
            return stored(api)["resourceclaims/ns1/c1"], \
                again.status.allocation.node_selector
        rj, rp = run_both(run)
        assert rp == rj
        alloc = rp[0]["status"]["allocation"]
        assert alloc["results"][0]["device"] == "chip-0"
        assert "nodeSelectorTerms" in alloc["nodeSelector"]
        assert rp[1] == {"kubernetes.io/hostname": "n1"}

    def test_list_with_label_selector(self):
        def run(pkg, client, api):
            s1 = make_slice(pkg, name="s1")
            s1.metadata.labels = {"role": "gang"}
            client.create(s1)
            client.create(make_slice(pkg, name="s2"))
            return [s.metadata.name for s in client.list(
                "ResourceSlice", label_selector={"role": "gang"})]
        assert run_both(run) == (["s1"], ["s1"])


class TestReviewRegressions:
    def test_deallocation_clears_status(self):
        def run(pkg, client, api):
            api.objects["resourceclaims/ns1/c1"] = {
                "metadata": {"name": "c1", "namespace": "ns1",
                             "uid": "u-1", "resourceVersion": "3"},
                "spec": {"devices": {"requests": [{"name": "tpu"}]}},
                "status": {"allocation": {"results": [
                    {"request": "tpu", "pool": "n1", "device": "chip-0"}]}},
            }
            claim = client.get("ResourceClaim", "ns1", "c1")
            had = claim.status.allocation is not None
            claim.status.allocation = None
            client.update(claim)
            return had, stored(api)["resourceclaims/ns1/c1"]
        rj, rp = run_both(run)
        assert rp == rj and rp[0]
        assert not rp[1].get("status", {}).get("allocation")

    def test_clearing_last_label_propagates(self):
        def run(pkg, client, api):
            api.objects["nodes//n1"] = {
                "metadata": {"name": "n1", "resourceVersion": "5",
                             "labels": {"tpu.google.com/slice": "s.4x4"}},
                "spec": {"podCIDR": "10.0.0.0/24"}}
            node = client.get("Node", "", "n1")
            node.metadata.labels.clear()
            client.update(node)
            return stored(api)["nodes//n1"]
        nj, np_ = run_both(run)
        assert np_ == nj and np_["metadata"]["labels"] == {}
        assert np_["spec"]["podCIDR"] == "10.0.0.0/24"

    def test_token_file_rotation(self, tmp_path):
        def run(pkg, client, api):
            tok = tmp_path / f"token-{pkg.name}"
            tok.write_text("tok-A")
            c = pkg.rest.RestClusterClient(
                api.url, auth={"token_file": str(tok)}, qps=0, burst=1)
            try:
                c.list("ResourceSlice")
                first = api.last_auth
                tok.write_text("tok-B")
                os.utime(tok, (time.time() + 5, time.time() + 5))
                c.list("ResourceSlice")
                return first, api.last_auth
            finally:
                c.close()
        assert run_both(run) == (("Bearer tok-A", "Bearer tok-B"),) * 2

    def test_token_bucket_zero_qps_is_unlimited(self):
        tb = PORT.flags.TokenBucket(qps=0, burst=1)
        for _ in range(50):
            tb.acquire()

    def test_token_bucket_zero_burst_does_not_hang(self):
        tb = PORT.flags.TokenBucket(qps=5, burst=0)
        assert (tb.burst, JAX.flags.TokenBucket(qps=5, burst=0).burst) == \
            (1, 1)
        for _ in range(10):
            tb.acquire()

    def test_kubeconfig_and_in_cluster_paths(self, tmp_path, monkeypatch):
        """Both packages read one kubeconfig to the same server and
        auth, and find no in-cluster config without a service account
        token."""
        cfg = tmp_path / "kubeconfig.yaml"
        cfg.write_text(
            "apiVersion: v1\nkind: Config\n"
            "clusters:\n- name: c\n  cluster:\n"
            "    server: http://127.0.0.1:1\n"
            "contexts:\n- name: x\n  context:\n    cluster: c\n"
            "    user: u\n    namespace: ns9\n"
            "current-context: x\n"
            "users:\n- name: u\n  user:\n    token: abc\n")
        got = [pkg.rest._load_kubeconfig(str(cfg)) for pkg in BOTH]
        assert got[1] == got[0]
        assert got[1][0] == "http://127.0.0.1:1"
        monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
        messages = []
        for pkg in BOTH:
            with pytest.raises(RuntimeError) as err:
                pkg.rest._load_in_cluster()
            messages.append(str(err.value))
        assert messages[1] == messages[0] and "--fake-cluster" in messages[1]


class TestWatch:
    def test_watch_sees_initial_and_live_events(self):
        def run(pkg, client, api):
            client.create(make_slice(pkg, name="pre"))
            events = []
            got_live = threading.Event()

            def handler(etype, obj):
                events.append((etype, obj.metadata.name))
                if obj.metadata.name == "live":
                    got_live.set()

            unsub = client.watch("ResourceSlice", handler)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and \
                    ("ADDED", "pre") not in events:
                time.sleep(0.02)
            initial = ("ADDED", "pre") in events
            client.create(make_slice(pkg, name="live"))
            live = got_live.wait(5)
            unsub()
            return initial, live
        assert run_both(run) == ((True, True),) * 2

    def test_relist_synthesizes_deleted_after_gap(self):
        def run(pkg, client, api):
            client.create(make_slice(pkg, name="doomed"))
            saw, deleted = threading.Event(), threading.Event()

            def handler(etype, obj):
                if obj.metadata.name == "doomed":
                    if etype == "ADDED":
                        saw.set()
                    if etype == "DELETED":
                        deleted.set()

            unsub = client.watch("ResourceSlice", handler)
            assert saw.wait(5)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and not api.watchers:
                time.sleep(0.02)
            assert api.watchers, "watch stream never connected"
            api.drop_watchers()
            with api._lock:
                del api.objects["resourceslices//doomed"]
            got = deleted.wait(10)
            unsub()
            return got
        assert run_both(run) == (True, True)

    def test_watch_claim_allocation_payload(self):
        def run(pkg, client, api):
            api.objects["resourceclaims/ns1/c1"] = {
                "metadata": {"name": "c1", "namespace": "ns1",
                             "uid": "u-1", "resourceVersion": "9"},
                "spec": {"devices": {"requests": [
                    {"name": "tpu", "deviceClassName": "tpu.google.com",
                     "count": 1}]}},
                "status": {"allocation": {"results": [
                    {"request": "tpu", "pool": "n1", "device": "chip-0",
                     "driver": "tpu.google.com"}]}},
            }
            claim = client.get("ResourceClaim", "ns1", "c1")
            return as_dict(claim)
        cj, cp = run_both(run)
        assert cp == cj
        assert cp["spec"]["devices"]["requests"][0]["device_class_name"] \
            == "tpu.google.com"
        res = cp["status"]["allocation"]["results"][0]
        assert (res["pool"], res["device"]) == ("n1", "chip-0")
