"""The demo specs through the port (the twin of tests/test_demo_specs.py).

Every file under ``demo/specs/`` is parsed and executed twice, on the JAX
package's ``E2EBed`` and on the port's ``PortE2EBed`` over the same fake
TPU hosts: claims and templates instantiated as the claim controller
would, pods scheduled by each package's allocator and prepared over
gRPC by each package's kubelet plugin, CDI applied.  Every pod's view
(env, device nodes, mounts), every claim's allocated devices and the
coordinator Deployments must be equal, and the documented expected
outputs hold for the port's run.  Then every ``demo/specs/h100/`` spec
runs through the port on fake H100 hosts, and each pod's containers run
here as processes under the claim's env, in an image without torch (a
``torch`` that fails to import shadows the installed one): each prints
its injected contract, which is held to the spec's documented output.
Both packages' beds keep their sockets under short ``/tmp`` paths."""

import ast
import copy
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from helpers import partition_config  # noqa: E402
from torch_acceptance import (SpecRunner, allocated, chips,  # noqa: E402
                              deployments, load, load_many, run_both,
                              torchless_image, view_record)
from torch_driver import JAX, PORT  # noqa: E402
from torch_testbed import PortE2EBed  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def no_sleep(monkeypatch):
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.plugin.DeviceState, "_sleep",
                            staticmethod(lambda s: None))


def one_v5e(pkg):
    return [pkg.discovery.FakeHost(hostname="tpu-host-0")]


def one_v5p(pkg):
    return [pkg.discovery.FakeHost(generation="v5p", hostname="p0")]


def spec_run(docs, select=None):
    """A scenario running every pod of ``docs`` (or ``select(runner)``'s
    list of pods) in order: each pod's views as records, every claim's
    allocation and the coordinator Deployments."""
    def scenario(bed, pkg):
        r = SpecRunner(bed, copy.deepcopy(docs), pkg.resource)
        pods = select(r) if select else r.pods
        views = []
        for pod in pods:
            v = r.run(pod)
            views.append([view_record(bed, x, r.claims) for x in v]
                         if isinstance(v, list) else
                         view_record(bed, v, r.claims))
        return dict(views=views,
                    claims=[(c.metadata.name, allocated(c))
                            for c in r.claims],
                    deployments=deployments(bed, r.claims))
    return scenario


class TestQuickstartThroughThePort:
    def test_tpu_test1_distinct_chips(self):
        out = run_both(one_v5e, spec_run(load("tpu-test1.yaml")))
        v1, v2 = out["views"]
        assert chips(v1) and chips(v2)
        assert set(chips(v1)).isdisjoint(chips(v2))
        assert v1["env"]["TPU_SKIP_MDS_QUERY"] == "true"

    def test_tpu_test2_containers_share_chip(self):
        docs = load("tpu-test2.yaml")
        (pod,) = docs["Pod"]
        assert len(pod["spec"]["containers"]) == 2
        (v,) = run_both(one_v5e, spec_run(docs))["views"]
        assert len(chips(v)) == 1
        assert v["env"]["TPU_RUNTIME_PREEMPTION_MS"] == "20"

    def test_tpu_test3_pods_share_claim(self):
        v1, v2 = run_both(one_v5e, spec_run(load("tpu-test3.yaml")))["views"]
        assert chips(v1) == chips(v2)
        assert "TPU_RUNTIME_PREEMPTION_MS" in v1["env"]

    def test_tpu_test4_paired_cores_same_chip(self):
        (v,) = run_both(one_v5p, spec_run(load("tpu-test4.yaml")))["views"]
        pairs = [p.split(":") for p in v["env"]["TPU_VISIBLE_CORES"]
                 .split(",")]
        assert len(pairs) == 2
        assert len({c for c, _ in pairs}) == 1
        assert len({j for _, j in pairs}) == 2
        assert chips(v) == [int(pairs[0][0])]

    def test_tpu_test5_both_strategies(self):
        out = run_both(one_v5e, spec_run(load("tpu-test5.yaml")))
        (v,) = out["views"]
        assert len(chips(v)) == 2
        assert v["env"]["TPU_RUNTIME_PREEMPTION_MS"] == "1"
        assert v["env"]["TPU_COORDINATOR_DUTY_CYCLE_PCT"] == "50"
        assert len(out["deployments"]) == 1

    def test_tpu_test6_cel_selector(self):
        (v,) = run_both(one_v5e, spec_run(load("tpu-test6.yaml")))["views"]
        assert chips(v) == [1]

    def test_tpu_test_coordinator_shared(self):
        out = run_both(one_v5e, spec_run(load("tpu-test-coordinator.yaml")))
        v1, v2 = out["views"]
        assert chips(v1) == chips(v2)
        assert v1["env"]["TPU_COORDINATOR_DUTY_CYCLE_PCT"] == "50"
        assert v1["env"]["TPU_COORDINATOR_DIR"] == "/coordination"
        assert len(out["deployments"]) == 1

    def test_tpu_test_enforced_gated_workloads(self):
        docs = load("tpu-test-enforced.yaml")
        out = run_both(one_v5e, spec_run(docs))
        v1, v2 = out["views"]
        assert chips(v1) == chips(v2)
        assert v1["env"]["TPU_COORDINATOR_DIR"] == "/coordination"
        assert len(out["deployments"]) == 1
        scripts = (REPO / "pyproject.toml").read_text()
        assert "tpu-coordclient = " in scripts
        jax_gate = __import__("k8s_dra_driver_tpu.coordclient.gate",
                              fromlist=["gate"])
        port_gate = __import__(
            "k8s_dra_driver_tpu_torch.coordclient.gate", fromlist=["gate"])
        for pod in docs["Pod"]:
            ctr = pod["spec"]["containers"][0]
            assert ctr["command"] == ["tpu-coordclient"]
            assert ctr["image"] == "tpu-dra-driver:dev"
            args = list(ctr["args"])
            sep = args.index("--")
            ns = port_gate.build_parser().parse_args(args[:sep])
            assert vars(ns) == vars(
                jax_gate.build_parser().parse_args(args[:sep]))
            assert ns.command == "exec"
            assert ns.name in ("pod1", "pod2")
            assert args[sep + 1:][0] == "python"

    def test_tpu_test_slice_contiguous(self):
        (v,) = run_both(one_v5e, spec_run(load("tpu-test-slice.yaml")))["views"]
        assert len(chips(v)) == 4
        assert len(v["device_nodes"]) >= 4

    def test_slice_test1_gang(self):
        docs = load("slice-test1.yaml")
        (dep,) = docs["Deployment"]

        def scenario(bed, pkg):
            r = SpecRunner(bed, copy.deepcopy(docs), pkg.resource)
            channel = r.shared["gang-a-channel"]
            views = []
            for i in range(int(dep["spec"]["replicas"])):
                chip_claim = r.from_template(f"replica{i}-tpu", "host-chips",
                                             "slice-test1")
                v_chip = bed.run_pod(chip_claim)
                v_chan = bed.run_pod(channel, node=v_chip.node)
                views.append((view_record(bed, v_chip, r.claims),
                              view_record(bed, v_chan, r.claims)))
            return dict(views=views, claims=[(c.metadata.name, allocated(c))
                                             for c in r.claims])

        out = run_both(lambda pkg: pkg.discovery.fake_slice_hosts(
            4, topology="4x4"), scenario)
        merged = [{**c["env"], **ch["env"]} for c, ch in out["views"]]
        assert len({e["TPU_RENDEZVOUS_CHANNEL"] for e in merged}) == 1
        assert len({e["TPU_WORKER_ID"] for e in merged}) == 4
        assert {e["TPU_TOPOLOGY"] for e in merged} == {"4x4"}
        for v_chip, _ in out["views"]:
            assert len(chips(v_chip)) == 4

    def test_tpu_test_serve_decodes_on_claimed_chip(self):
        docs = load("tpu-test-serve.yaml")
        (v,) = run_both(one_v5e, spec_run(docs))["views"]
        assert len(chips(v)) == 1
        args = docs["Pod"][0]["spec"]["containers"][0]["args"][0]
        assert "decode_probe" in args
        assert "TPU_VISIBLE_CHIPS" in args
        # the port's ops package answers the spec's imports, and its
        # probes take the spec's arguments
        from k8s_dra_driver_tpu_torch import ops
        for name, kwargs in probe_calls(args).items():
            inspect.signature(getattr(ops, name)).bind(**kwargs)


class TestOtherDemosThroughThePort:
    def test_selectors_demo_inference_vs_training(self):
        docs = load_many("selectors", "claims.yaml", "pods.yaml")

        def select(r):
            by_name = {p["metadata"]["name"]: p for p in r.pods}
            return [by_name["inference-pod"], by_name["training-pod"]]

        vi, vt = run_both(lambda pkg: [
            pkg.discovery.FakeHost(generation="v5p", hostname="p0"),
            pkg.discovery.FakeHost(hostname="e0")],
            spec_run(docs, select))["views"]
        assert len(vi["env"]["TPU_VISIBLE_CORES"].split(",")) == 1
        assert vi["node"] == "p0"
        assert len(chips(vt)) == 4
        assert vt["node"] == "e0"

    def test_sharing_demo_matrix(self):
        docs = load_many("partition+coordinated", "sharing-demo-claims.yaml",
                         "sharing-demo-job.yaml")
        (job,) = docs["Job"]
        docs["Pod"] = [
            {"kind": "Pod",
             "metadata": {"name": f"sharing-demo-job-{i}",
                          "namespace": "sharing-demo"},
             "spec": copy.deepcopy(job["spec"]["template"]["spec"])}
            for i in range(int(job["spec"]["parallelism"]))]
        out = run_both(one_v5p, spec_run(docs))
        assert sorted(name for name, _ in out["claims"]) == sorted(
            ["chip-ts-sharing", "chip-co-sharing", "core-co-sharing",
             "core-exclusive"])
        claim_names = [c["name"] for c in
                       job["spec"]["template"]["spec"]["resourceClaims"]]
        per_claim = dict(zip(claim_names, zip(*out["views"])))
        for name, vs in per_claim.items():
            assert len({tuple(chips(v)) for v in vs}) == 1, name
        assert per_claim["chip-ts-sharing"][0]["env"][
            "TPU_RUNTIME_PREEMPTION_MS"] == "5"
        assert per_claim["chip-co-sharing"][0]["env"][
            "TPU_COORDINATOR_DUTY_CYCLE_PCT"] == "50"
        core_co = per_claim["core-co-sharing"][0]["env"]
        assert core_co["TPU_COORDINATOR_DUTY_CYCLE_PCT"] == "25"
        assert len(core_co["TPU_VISIBLE_CORES"].split(",")) == 1
        assert core_co["TPU_VISIBLE_CORES"] != per_claim[
            "core-exclusive"][0]["env"]["TPU_VISIBLE_CORES"]
        assert len(out["deployments"]) == 2

    def test_partition_timeslicing_rejected(self):
        def scenario(bed, pkg):
            r = pkg.resource
            claim = bed.create_claim(r.ResourceClaim(
                metadata=r.ObjectMeta(name="bad-ts",
                                      namespace="sharing-demo"),
                spec=r.ResourceClaimSpec(devices=r.DeviceClaim(
                    requests=[r.DeviceRequest(
                        name="core", device_class_name="tpu-core.google.com",
                        count=1)],
                    config=[r.ClaimConfig(opaque=r.OpaqueConfig(
                        driver="tpu.google.com",
                        parameters=partition_config(
                            "TimeSlicing",
                            timeSlicing={"interval": "Short"})))]))))
            with pytest.raises(RuntimeError, match="TimeSlicing") as err:
                bed.run_pod(claim)
            return dict(error=str(err.value).replace(claim.metadata.uid,
                                                     "<uid>"),
                        claims=[(claim.metadata.name, allocated(claim))])
        run_both(one_v5p, scenario)


def probe_calls(script: str) -> dict[str, dict]:
    """The keyword arguments of the script's ``decode_probe`` and
    ``serving_probe`` calls."""
    out = {}
    for node in ast.walk(ast.parse(script)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("decode_probe", "serving_probe")):
            out[node.func.id] = {k.arg: ast.literal_eval(k.value)
                                 for k in node.keywords}
    return out


# -- the H100 specs on fake H100 hosts ----------------------------------

NODE = "h100-node"


@pytest.fixture(scope="module")
def no_torch(tmp_path_factory) -> Path:
    return torchless_image(tmp_path_factory.mktemp("image"))


def h100_bed(cards: int) -> PortE2EBed:
    return PortE2EBed([PORT.discovery.FakeHost(
        generation="h100", num_chips=cards, hostname=NODE)])


def card_uuids(bed) -> list[str]:
    """The node's cards' UUIDs in minor order."""
    return [c.uuid for c in sorted(bed.hosts[NODE].nvidia_cards(),
                                   key=lambda c: c.minor)]


def container_env(view, no_torch: Path) -> dict:
    """This process's environment without ``CUDA_VISIBLE_DEVICES``, the
    claim's env on top, the checkout on ``PYTHONPATH`` behind
    ``no_torch``."""
    env = {k: v for k, v in os.environ.items()
           if k != "CUDA_VISIBLE_DEVICES"}
    env.update(view.env)
    env["PYTHONPATH"] = os.pathsep.join([str(no_torch), str(REPO)])
    return env


def argv_of(argv: list[str]) -> list[str]:
    return [sys.executable if a == "python" else a for a in argv]


def run_container(ctr: dict, view, no_torch: Path) -> str:
    """A container's command as a process under ``container_env``; its
    output."""
    done = subprocess.run(argv_of(ctr["command"] + ctr.get("args", [])),
                          env=container_env(view, no_torch), cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert done.returncode == 0, done.stderr
    return done.stdout


def line_of(out: str, prefix: str) -> str:
    (line,) = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    return line


def minors(bed) -> dict[str, int]:
    """Each card's minor by its UUID."""
    return {c.uuid: c.minor for c in bed.hosts[NODE].nvidia_cards()}


class TestH100Specs:
    """Each ``demo/specs/h100/`` spec through the port on a fake H100
    node, its documented expected output held."""

    @pytest.fixture
    def two_cards(self):
        bed = h100_bed(2)
        yield bed
        bed.shutdown()

    @pytest.fixture
    def one_card(self):
        bed = h100_bed(1)
        yield bed
        bed.shutdown()

    def run_pods(self, bed, name, no_torch, pods=None):
        """Every pod of the spec (or ``pods`` of them, by name), each
        container run: {container or pod name: (view, output)}."""
        r = SpecRunner(bed, load(name, subdir="h100"), PORT.resource)
        outs = {}
        for pod in r.pods:
            if pods is not None and pod["metadata"]["name"] not in pods:
                continue
            view = r.run(pod)
            ctrs = pod["spec"]["containers"]
            for ctr in ctrs:
                key = ctr["name"] if len(ctrs) > 1 else pod["metadata"]["name"]
                outs[key] = (view, run_container(ctr, view, no_torch))
        return r, outs

    def card_of(self, bed, key, view, out) -> str:
        """The one card a container was given: its UUID, printed by the
        container, its device node and the claim's env agreeing."""
        uuid = view.env["CUDA_VISIBLE_DEVICES"]
        assert uuid in minors(bed)
        assert line_of(out, f"{key} CUDA_VISIBLE_DEVICES").startswith(
            f"{key} CUDA_VISIBLE_DEVICES = {uuid}")
        assert f"/dev/nvidia{minors(bed)[uuid]}" in view.device_nodes
        assert "torch not installed" in out
        return uuid

    def test_tpu_test1_distinct_cards(self, two_cards, no_torch):
        bed = two_cards
        _, outs = self.run_pods(bed, "tpu-test1.yaml", no_torch)
        uuids = [self.card_of(bed, k, v, o) for k, (v, o) in outs.items()]
        assert sorted(uuids) == sorted(card_uuids(bed))
        for view, _ in outs.values():
            assert view.env["NVIDIA_VISIBLE_DEVICES"] == "void"
            assert not any(k.startswith("TPU_VISIBLE") for k in view.env)

    def test_tpu_test1_one_card_second_pod_waits(self, one_card):
        bed = one_card
        r = SpecRunner(bed, load("tpu-test1.yaml", subdir="h100"),
                       PORT.resource)
        pod1, pod2 = r.pods
        (c1,), (c2,) = r.claims_for(pod1), r.claims_for(pod2)
        v1 = bed.run_pod(c1)
        with pytest.raises(PORT.allocator.AllocationError):
            bed.schedule(c2)
        bed.delete_pod(c1, v1.node)
        bed.cluster.delete("ResourceClaim", c1.metadata.namespace,
                           c1.metadata.name)
        v2 = bed.run_pod(c2)
        assert v2.env["CUDA_VISIBLE_DEVICES"] == \
            v1.env["CUDA_VISIBLE_DEVICES"] == card_uuids(bed)[0]
        assert allocated(c2) == [("gpu", NODE, f"chip-{minors(bed)[
            card_uuids(bed)[0]]}")]

    def test_tpu_test2_containers_share_card(self, two_cards, no_torch):
        bed = two_cards
        r, outs = self.run_pods(bed, "tpu-test2.yaml", no_torch)
        assert len(r.claims) == 1
        uuids = {self.card_of(bed, k, v, o) for k, (v, o) in outs.items()}
        assert len(uuids) == 1
        for key, (_, out) in outs.items():
            assert line_of(out, f"{key} CUDA_VISIBLE_DEVICES").endswith(
                "preemption = 20")

    def test_tpu_test3_pods_share_claim(self, two_cards, no_torch):
        bed = two_cards
        r, outs = self.run_pods(bed, "tpu-test3.yaml", no_torch)
        assert len(r.claims) == 1
        uuids = {self.card_of(bed, k, v, o) for k, (v, o) in outs.items()}
        assert len(uuids) == 1 and set(outs) == {"pod1", "pod2"}
        assert all("TPU_RUNTIME_PREEMPTION_MS" in v.env
                   for v, _ in outs.values())

    def test_tpu_test5_both_strategies(self, two_cards, no_torch):
        bed = two_cards
        _, outs = self.run_pods(bed, "tpu-test5.yaml", no_torch)
        both_cards = ",".join(card_uuids(bed))
        ts_view, ts = outs["ts-ctr"]
        _, co = outs["coord-ctr"]
        assert ts_view.env["CUDA_VISIBLE_DEVICES"] == both_cards
        assert line_of(ts, "ts CUDA_VISIBLE_DEVICES") == \
            f"ts CUDA_VISIBLE_DEVICES = {both_cards} preemption = 1"
        assert line_of(co, "coord CUDA_VISIBLE_DEVICES") == \
            f"coord CUDA_VISIBLE_DEVICES = {both_cards} duty = 50 " \
            "dir = /coordination"
        assert sorted(ts_view.device_nodes)[-2:] == sorted(
            f"/dev/nvidia{m}" for m in minors(bed).values())
        assert len(bed.cluster.list("Deployment")) == 1

    def test_tpu_test5_one_card_refused(self, one_card):
        r = SpecRunner(one_card, load("tpu-test5.yaml", subdir="h100"),
                       PORT.resource)
        (claim,) = r.claims_for(r.pods[0])
        with pytest.raises(PORT.allocator.AllocationError):
            one_card.schedule(claim)

    def test_tpu_test6_cel_selector(self, two_cards, no_torch):
        bed = two_cards
        r, outs = self.run_pods(bed, "tpu-test6.yaml", no_torch)
        (key, (view, out)), = outs.items()
        uuid = self.card_of(bed, key, view, out)
        ((req, pool, device),) = allocated(r.claims[0])
        assert device == f"chip-{minors(bed)[uuid]}"
        # the selector names what an H100 publishes, and nothing a TPU
        # host publishes matches it
        tpu = PortE2EBed([PORT.discovery.FakeHost(hostname="tpu-host-0")])
        try:
            c = SpecRunner(tpu, load("tpu-test6.yaml", subdir="h100"),
                           PORT.resource).claims_for(r.pods[0])[0]
            with pytest.raises(PORT.allocator.AllocationError):
                tpu.schedule(c)
        finally:
            tpu.shutdown()

    def test_tpu_test_coordinator_shared(self, two_cards, no_torch):
        bed = two_cards
        _, outs = self.run_pods(bed, "tpu-test-coordinator.yaml", no_torch)
        uuids = {self.card_of(bed, k, v, o) for k, (v, o) in outs.items()}
        assert len(uuids) == 1
        for key, (view, out) in outs.items():
            assert line_of(out, f"{key} CUDA_VISIBLE_DEVICES").endswith(
                "duty = 50 dir = /coordination")
            assert any(m["containerPath"] == "/coordination"
                       for m in view.mounts)
        assert len(bed.cluster.list("Deployment")) == 1

    def test_tpu_test_enforced_gated_workloads(self, two_cards, no_torch):
        """Both pods' entrypoint is the port's gate, run as a module;
        their args parse with its parser and the workload after ``--``
        runs (here without the gate, as an image without torch)."""
        from k8s_dra_driver_tpu_torch.coordclient import gate
        bed = two_cards
        r = SpecRunner(bed, load("tpu-test-enforced.yaml", subdir="h100"),
                       PORT.resource)
        views, procs = {}, {}
        for pod in r.pods:
            name = pod["metadata"]["name"]
            ctr = pod["spec"]["containers"][0]
            assert ctr["command"] == [
                "python", "-m", "k8s_dra_driver_tpu_torch.coordclient.gate"]
            args = list(ctr["args"])
            sep = args.index("--")
            ns = gate.build_parser().parse_args(args[:sep])
            assert (ns.command, ns.name) == ("exec", name)
            views[name] = r.run(pod)
            procs[name] = subprocess.Popen(
                argv_of(args[sep + 1:]),
                env=container_env(views[name], no_torch), cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, p in procs.items():
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            self.card_of(bed, name, views[name], out)
            assert int(line_of(out, f"{name} ticks=").split("=")[1]) > 0
        assert len({v.env["CUDA_VISIBLE_DEVICES"]
                    for v in views.values()}) == 1
        assert len(bed.cluster.list("Deployment")) == 1

    def test_tpu_test_serve_on_claimed_card(self, two_cards, no_torch):
        bed = two_cards
        _, outs = self.run_pods(bed, "tpu-test-serve.yaml", no_torch)
        ((key, (view, out)),) = outs.items()
        uuid = view.env["CUDA_VISIBLE_DEVICES"]
        assert line_of(out, "serve CUDA_VISIBLE_DEVICES") == \
            f"serve CUDA_VISIBLE_DEVICES = {uuid}"
        assert "env contract only" in out
        # the JAX serving spec's widths, call for call
        ours = load("tpu-test-serve.yaml", subdir="h100")["Pod"][0]
        theirs = load("tpu-test-serve.yaml")["Pod"][0]
        ours, theirs = (probe_calls(p["spec"]["containers"][0]["args"][0])
                        for p in (ours, theirs))
        assert ours == theirs and set(ours) == {"decode_probe",
                                                "serving_probe"}
        from k8s_dra_driver_tpu_torch import ops
        for name, kwargs in ours.items():
            inspect.signature(getattr(ops, name)).bind(**kwargs)
