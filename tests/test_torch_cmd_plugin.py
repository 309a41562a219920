"""The port's plugin command against the JAX package's (the twin of the
plugin classes of tests/test_cmd.py): flags and their env mirrors,
validation, ``--visible-chips``, ``run`` end to end on a fake topology
(publication, sockets, the HTTP endpoint, shutdown), the version
string; and the pin that the command's import graph loads no
``torch``, ``jax`` or JAX package module."""

import json
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import grpc
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_driver import BOTH, JAX, PORT  # noqa: E402
from torch_plugin import make_allocated_claim, short_dir  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


#: the port's one plugin flag beyond the JAX package's (CDI hostPaths
#: as the node sees them; ROADMAP Queue C 51), held in its own test
HOST_ROOT_FLAG = "--host-driver-root"


def parse(pkg, argv):
    return pkg.cmd_plugin.build_parser().parse_args(argv)


def jax_surface(parser):
    """``parser`` without the port's ``--host-driver-root``."""
    action = parser._option_string_actions.pop(HOST_ROOT_FLAG, None)
    if action is not None:
        parser._remove_action(action)
        for group in parser._action_groups:
            if action in group._group_actions:
                group._group_actions.remove(action)
    return parser


def parsed_both(argv, validate=True):
    """Both packages' parsed flags; the port's ``host_driver_root``
    (None unless given) is left out."""
    out = []
    for pkg in BOTH:
        args = parse(pkg, argv)
        if validate:
            pkg.cmd_plugin.validate(args)
        flags = vars(args)
        if pkg is PORT:
            flags.pop("host_driver_root")
        out.append(flags)
    return tuple(out)


def exit_message(pkg, argv):
    with pytest.raises(SystemExit) as err:
        pkg.cmd_plugin.validate(parse(pkg, argv))
    return str(err.value)


class TestPluginFlags:
    def test_defaults(self):
        aj, ap = parsed_both(["--node-name", "n1"])
        assert ap == aj
        assert ap["plugin_root"] == PORT.cmd_plugin.DEFAULT_PLUGIN_ROOT
        assert ap["cdi_root"] == PORT.cmd_plugin.DEFAULT_CDI_ROOT
        assert ap["kube_api_qps"] == 5.0 and ap["kube_api_burst"] == 10
        assert ap["discovery"] == "sysfs" and ap["fake_topology"] == ""
        assert set(ap["device_kinds"]) == {"chip", "core", "slice"}

    def test_env_mirrors(self, monkeypatch):
        monkeypatch.setenv("NODE_NAME", "from-env")
        monkeypatch.setenv("CDI_ROOT", "/tmp/cdi-env")
        monkeypatch.setenv("KUBE_API_QPS", "50")
        monkeypatch.setenv("DISCOVERY", "auto")
        aj, ap = parsed_both([], validate=False)
        assert ap == aj
        assert (ap["node_name"], ap["cdi_root"], ap["kube_api_qps"],
                ap["discovery"]) == ("from-env", "/tmp/cdi-env", 50.0,
                                     "auto")

    def test_cli_beats_env(self, monkeypatch):
        monkeypatch.setenv("NODE_NAME", "from-env")
        aj, ap = parsed_both(["--node-name", "from-cli"], validate=False)
        assert ap == aj and ap["node_name"] == "from-cli"

    def test_node_name_required(self):
        mj, mp = (exit_message(p, []) for p in BOTH)
        assert mp == mj and "--node-name" in mp

    def test_bad_device_class(self):
        argv = ["--node-name", "n", "--device-classes", "chip,gpu"]
        mj, mp = (exit_message(p, argv) for p in BOTH)
        assert mp == mj and "gpu" in mp

    def test_device_class_gating(self):
        aj, ap = parsed_both(["--node-name", "n", "--device-classes",
                              "chip"])
        assert ap == aj and ap["device_kinds"] == ("chip",)

    def test_controller_classes_accepted_and_ignored(self):
        aj, ap = parsed_both(
            ["--node-name", "n",
             "--device-classes", "chip,core,slice,rendezvous,podslice"])
        assert ap == aj
        assert set(ap["device_kinds"]) == {"chip", "core", "slice"}

    def test_only_controller_classes_rejected(self):
        argv = ["--node-name", "n", "--device-classes", "podslice"]
        mj, mp = (exit_message(p, argv) for p in BOTH)
        assert mp == mj and "node-level" in mp

    def test_help_texts_equal(self):
        hj, hp = (jax_surface(pkg.cmd_plugin.build_parser()).format_help()
                  for pkg in BOTH)
        assert hp == hj
        assert HOST_ROOT_FLAG in PORT.cmd_plugin.build_parser().format_help()

    def test_host_driver_root(self, monkeypatch):
        """Unset, CDI hostPaths keep the driver root (the JAX package's
        specs); the env mirror and the flag name the node's root."""
        assert parse(PORT, ["--node-name", "n"]).host_driver_root is None
        monkeypatch.setenv("HOST_DRIVER_ROOT", "/")
        args = parse(PORT, ["--node-name", "n", "--driver-root", "/host"])
        assert (args.driver_root, args.host_driver_root) == ("/host", "/")
        assert parse(PORT, ["--node-name", "n", HOST_ROOT_FLAG,
                            "/node"]).host_driver_root == "/node"


class TestVisibleChipsFlag:
    def test_default_is_unmasked(self):
        assert [parse(p, ["--node-name", "n"]).visible_chips
                for p in BOTH] == ["", ""]

    def test_env_mirror(self, monkeypatch):
        monkeypatch.setenv("VISIBLE_CHIPS", "0,1")
        assert [parse(p, []).visible_chips for p in BOTH] == ["0,1"] * 2

    def test_mask_backend_wraps_discovery(self, tmp_path):
        def run(pkg):
            root = tmp_path / pkg.name[-5:]
            backend = pkg.discovery.FakeHost(num_chips=4).materialize(root)
            (root / "visible_chips").write_text("1,2\n")
            args = parse(pkg, ["--node-name", "n", "--driver-root",
                               str(root), "--visible-chips",
                               "@/visible_chips"])
            masked = pkg.cmd_plugin.mask_backend(args, backend)
            passthrough = pkg.cmd_plugin.mask_backend(
                parse(pkg, ["--node-name", "n"]), backend) is backend
            return [c.index for c in masked.enumerate().chips], passthrough
        assert run(PORT) == run(JAX) == ([1, 2], True)

    def test_mask_selects_one_card_of_an_nvidia_host(self, tmp_path):
        backend = PORT.discovery.FakeHost(
            generation="h100", num_chips=2, nvidia="procfs",
            hostname="g").materialize(tmp_path)
        args = parse(PORT, ["--node-name", "g", "--visible-chips", "6"])
        masked = PORT.cmd_plugin.mask_backend(args, backend)
        assert [c.index for c in masked.enumerate().chips] == [6]


def run_plugin(pkg, root, topo, client, extra=()):
    """``cmd.plugin.run`` on a thread with a fake topology file; returns
    (thread, stop event, args) once the plugin is ready."""
    root.mkdir(parents=True, exist_ok=True)
    topo_file = root / "topo.json"
    topo_file.write_text(json.dumps(topo))
    args = parse(pkg, [
        "--node-name", topo.get("hostname", "n1"),
        "--plugin-root", str(root / "plugin"),
        "--registrar-root", str(root / "registry"),
        "--cdi-root", str(root / "cdi"),
        "--fake-topology", str(topo_file),
        "--fake-cluster", *extra])
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=pkg.cmd_plugin.run, args=(args,),
                         kwargs=dict(client=client, ready_event=ready,
                                     stop_event=stop), daemon=True)
    t.start()
    assert ready.wait(20), "plugin did not become ready"
    return t, stop, args


class TestPluginRun:
    def test_end_to_end_with_fake_topology(self):
        base = short_dir("tcmd-")

        def run(pkg):
            root = base / pkg.name[-5:]
            client = pkg.cluster.FakeCluster()
            client.create(pkg.cluster.Node(
                metadata=pkg.resource.ObjectMeta(name="n1")))
            t, stop, _ = run_plugin(
                pkg, root, {"generation": "v5e", "num_chips": 4,
                            "hostname": "n1", "root": str(root / "tree")},
                client, ["--http-endpoint", "127.0.0.1:0"])
            try:
                slices = client.list("ResourceSlice")
                names = sorted(d.name for s in slices for d in s.devices)
                sockets = sorted(p.name for p in (root / "registry")
                                 .iterdir())
                spec = (root / "cdi/tpu.google.com-chip.json").read_text()
            finally:
                stop.set()
                t.join(timeout=10)
            assert not t.is_alive()
            return names, sockets, spec.replace(str(root), "<R>")
        try:
            rj, rp = run(JAX), run(PORT)
        finally:
            shutil.rmtree(base, ignore_errors=True)
        assert rp == rj
        assert "chip-0" in rp[0] and len(rp[0]) == 13
        assert rp[1] == ["tpu.google.com-reg.sock"]

    def test_nvidia_topology_prepares_over_grpc(self):
        """The port's command on a fake H100 host: the card's devices
        are published, and a gRPC prepare writes a claim spec naming
        the card by UUID."""
        base = short_dir("tcmdg-")
        client = PORT.cluster.FakeCluster()
        t, stop, args = run_plugin(
            PORT, base, {"generation": "h100", "num_chips": 1,
                         "hostname": "g1", "nvidia": "procfs",
                         "root": str(base / "tree")}, client,
            ["--health-interval", "0"])
        try:
            (s,) = client.list("ResourceSlice")
            assert sorted(d.name for d in s.devices) == ["chip-4",
                                                         "chip-4-core-0"]
            client.create(make_allocated_claim(PORT, "g", [("r0", "chip-4")],
                                               pool="g1"))
            pb = PORT.proto.dra_pb2
            stub = PORT.proto.DRAPluginStub(grpc.insecure_channel(
                f"unix://{base / 'plugin' / 'plugin.sock'}"))
            resp = stub.NodePrepareResources(pb.NodePrepareResourcesRequest(
                claims=[pb.Claim(uid="uid-g", namespace="default",
                                 name="g")]))
            assert resp.claims["uid-g"].error == ""
            spec = json.loads((base / "cdi" /
                               "tpu.google.com-claim_uid-g.json").read_text())
            assert spec["devices"][0]["containerEdits"]["env"] == [
                "CUDA_VISIBLE_DEVICES=" + PORT.discovery.H100_PROBE[0].uuid]
        finally:
            stop.set()
            t.join(timeout=10)
            shutil.rmtree(base, ignore_errors=True)
        assert not t.is_alive()

    def test_no_card_and_no_fake_topology_refuses(self, tmp_path):
        """Without ``--fake-topology`` discovery reads the live host and
        never falls back to a fake one: on this card-less tree the
        plugin publishes nothing."""
        args = parse(PORT, ["--node-name", "n", "--driver-root",
                            str(tmp_path)])
        topo = PORT.cmd_plugin.build_backend(args).enumerate()
        assert topo.chips == ()


class TestHTTPEndpoint:
    def test_serves_metrics_health_and_stacks(self):
        ep = PORT.httpendpoint.HTTPEndpoint("127.0.0.1:0",
                                            PORT.metrics.DriverMetrics())
        ep.start()
        try:
            base = f"http://{ep.address}"
            body = urllib.request.urlopen(f"{base}/metrics").read()
            assert b"tpu_dra_prepared_claims" in body
            assert urllib.request.urlopen(f"{base}/healthz").read() == b"ok"
            stacks = urllib.request.urlopen(
                f"{base}/debug/pprof/goroutine").read().decode()
            assert "thread MainThread" in stacks
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(f"{base}/nope")
        finally:
            ep.stop()


def test_version_string():
    assert PORT.info.get_version_string().startswith(PORT.info.version)
    assert PORT.info.version == JAX.info.version
    assert PORT.info.DRIVER_NAME == JAX.info.DRIVER_NAME


def test_import_graph_loads_no_torch():
    """The command's modules, imported and run through flag validation
    and a fake-cluster client in a fresh interpreter, load no torch, no
    jax and nothing of the JAX package."""
    code = (
        "import sys\n"
        "import k8s_dra_driver_tpu_torch.cmd.plugin as p\n"
        "import k8s_dra_driver_tpu_torch.plugin.health\n"
        "import k8s_dra_driver_tpu_torch.cluster.rest\n"
        "a = p.build_parser().parse_args(['--node-name', 'n', "
        "'--fake-cluster'])\n"
        "p.validate(a)\n"
        "p.KubeClientConfig.build_client(a)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'k8s_dra_driver_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
