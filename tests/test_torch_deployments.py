"""Deployment-layer checks of the port (the twin of
tests/test_deployments.py), applied to the port's chart
(``deployments/helm/tpu-dra-driver-torch``), its image
(``deployments/container/Dockerfile.torch``) and the H100 demo specs
(``demo/specs/h100``).

helm is not available here, so the templates are YAML-parseable
(templating only inside string values, or on lines of their own) and
are checked structurally, as the JAX chart's are; the chart's commands
and environment are checked against the port's own argument parsers,
and the commands the image smoke-checks run here in an interpreter
where torch cannot be imported."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

sys.path.insert(0, str(Path(__file__).parent))

from torch_acceptance import torchless_image  # noqa: E402

REPO = Path(__file__).parent.parent
CHART = REPO / "deployments" / "helm" / "tpu-dra-driver-torch"
JAX_CHART = REPO / "deployments" / "helm" / "tpu-dra-driver"
DOCKERFILE = REPO / "deployments" / "container" / "Dockerfile.torch"
H100_SPECS = REPO / "demo" / "specs" / "h100"
PKG = "k8s_dra_driver_tpu_torch"


def load_template(name: str, chart: Path = CHART) -> list[dict]:
    """A template parsed: pure-template control lines dropped, inline
    {{ }} expressions turned into placeholder scalars."""
    text = (chart / "templates" / name).read_text()
    kept = [re.sub(r"\{\{[^}]*\}\}", "TPL", line)
            for line in text.splitlines()
            if not re.match(r"^\s*\{\{", line)]
    return [d for d in yaml.safe_load_all("\n".join(kept)) if d]


def values() -> dict:
    return yaml.safe_load((CHART / "values.yaml").read_text())


def plugin_container() -> dict:
    (ds,) = load_template("kubeletplugin.yaml")
    assert ds["kind"] == "DaemonSet"
    (ctr,) = ds["spec"]["template"]["spec"]["containers"]
    return ctr


def test_chart_metadata():
    chart = yaml.safe_load((CHART / "Chart.yaml").read_text())
    assert chart["name"] == "tpu-dra-driver-torch"
    assert chart["kubeVersion"] == yaml.safe_load(
        (JAX_CHART / "Chart.yaml").read_text())["kubeVersion"]
    v = values()
    assert set(v["deviceClasses"]) == {
        "chip", "core", "slice", "rendezvous", "podslice"}
    assert v["namespace"] == "tpu-dra-driver"
    assert v["kubeletPlugin"]["nodeSelector"] == {
        "nvidia.com/gpu.present": "true"}


def test_daemonset_mounts_kubelet_and_nvidia_contract():
    ctr = plugin_container()
    assert ctr["command"] == ["python", "-m", f"{PKG}.cmd.plugin"]
    assert ctr["securityContext"]["privileged"] is True
    mounts = {m["mountPath"]: m for m in ctr["volumeMounts"]}
    for path in ("/var/lib/kubelet/plugins/tpu.google.com",
                 "/var/lib/kubelet/plugins_registry", "/var/run/cdi"):
        assert path in mounts
    # the driver root's NVIDIA contract, read-only under DRIVER_ROOT:
    # the device nodes, the driver's library directory, procfs, sysfs
    env = {e["name"]: e.get("value") for e in ctr["env"]}
    assert env["DRIVER_ROOT"] == "/host"
    host = {p: m for p, m in mounts.items() if p.startswith("/host")}
    assert set(host) == {"/host/dev", "/host/TPL",
                         "/host/proc/driver/nvidia", "/host/sys"}
    assert all(m.get("readOnly") is True for m in host.values())
    assert "/host" not in mounts, "the whole host root is not mounted"


def test_driver_root_holds_what_the_cdi_specs_emit():
    """The library directory the chart mounts is the first place the
    port's discovery looks for ``libcuda.so.1``; the device nodes the
    port's CDI specs name all live under the mounted ``/dev``."""
    from k8s_dra_driver_tpu_torch.discovery.sysfs import LIBCUDA_SEARCH_PATHS
    from k8s_dra_driver_tpu_torch.plugin import cdi
    lib_dir = values()["kubeletPlugin"]["driverLibDir"]
    assert f"{lib_dir}/libcuda.so.1" == LIBCUDA_SEARCH_PATHS[0]
    assert all(p.startswith("/dev/nvidia") for p in cdi.NVIDIA_COMMON_NODES)
    text = (CHART / "templates" / "kubeletplugin.yaml").read_text()
    assert '/host/{{ .Values.kubeletPlugin.driverLibDir }}"' in text
    # the CDI mounts' hostPaths: the driver root on the node, not /host
    assert re.search(r'- name: HOST_DRIVER_ROOT\n\s+value: "\{\{ '
                     r'\.Values\.kubeletPlugin\.driverRoot \}\}"', text)
    for sub in ("dev", "{{ .Values.kubeletPlugin.driverLibDir }}",
                "proc/driver/nvidia", "sys"):
        assert ('path: "{{ trimSuffix "/" .Values.kubeletPlugin.driverRoot '
                f'}}}}/{sub}"') in text, sub


def test_every_value_is_used():
    """Each value of the chart is read by a template (itself or a
    parent mapping handed on whole, as ``toYaml`` does); discovery is
    ``auto``, not a value."""
    text = "\n".join(p.read_text()
                     for p in sorted((CHART / "templates").glob("*.yaml")))

    def leaves(d, pre=()):
        for k, x in d.items():
            if isinstance(x, dict) and x:
                yield from leaves(x, pre + (k,))
            else:
                yield pre + (k,)
    for path in leaves(values()):
        assert any(re.search(r"\.Values\." + re.escape(".".join(path[:i]))
                             + r"(?![\w.])", text)
                   for i in range(1, len(path) + 1)), path
    env = {e["name"]: e.get("value") for e in plugin_container()["env"]}
    assert env["DISCOVERY"] == "auto"
    assert "discovery" not in values()["kubeletPlugin"]


def parser_env(module: str) -> set[str]:
    """The environment variables a command's parser reads
    (``env_default("NAME", ...)``), and its client and logging flags'."""
    src = (REPO / PKG / "cmd" / f"{module}.py").read_text()
    names = set(re.findall(r'env_default\(\s*"([A-Z_]+)"', src))
    flags = (REPO / PKG / "utils" / "flags.py").read_text()
    return names | set(re.findall(r'env_default\(\s*"([A-Z_]+)"', flags))


def test_plugin_env_is_what_the_port_reads():
    ctr = plugin_container()
    env = {e["name"] for e in ctr["env"]}
    for name in ("NODE_NAME", "PLUGIN_ROOT", "REGISTRAR_ROOT", "CDI_ROOT",
                 "DRIVER_ROOT", "DEVICE_CLASSES", "COORDINATOR_NAMESPACE",
                 "HTTP_ENDPOINT", "KUBE_API_QPS", "KUBE_API_BURST",
                 "VISIBLE_CHIPS", "DISCOVERY", "HOST_DRIVER_ROOT"):
        assert name in env, f"DaemonSet missing env {name}"
    assert env <= parser_env("plugin"), env - parser_env("plugin")


def test_controller_deployment():
    (dep,) = load_template("controller.yaml")
    (ctr,) = dep["spec"]["template"]["spec"]["containers"]
    assert ctr["command"] == ["python", "-m", f"{PKG}.cmd.controller"]
    env = {e["name"] for e in ctr["env"]}
    for name in ("NAMESPACE", "POD_NAME", "DEVICE_CLASSES",
                 "CHANNELS_PER_SLICE", "RETRY_DELAY_SECONDS"):
        assert name in env
    assert env <= parser_env("controller"), env - parser_env("controller")


def test_deviceclasses_match_code():
    from k8s_dra_driver_tpu_torch.api.classes import standard_device_classes
    in_chart = {d["metadata"]["name"]:
                d["spec"]["selectors"][0]["cel"]["expression"]
                for d in load_template("deviceclasses.yaml")}
    in_code = {name: cls.selectors[0].cel
               for name, cls in standard_device_classes().items()}
    assert set(in_chart) == set(in_code)
    for name, cel in in_code.items():
        assert " ".join(in_chart[name].split()) == " ".join(cel.split()), \
            f"chart CEL for {name} drifted from api/classes.py"


def test_rbac_is_scoped_and_equal_to_the_jax_chart():
    docs = load_template("rbac.yaml")
    roles = [d for d in docs if d["kind"] in ("ClusterRole", "Role")]
    assert roles
    for role in roles:
        for rule in role["rules"]:
            assert rule["apiGroups"] != ["*"], "wildcard RBAC forbidden"
            assert rule["resources"] != ["*"], "wildcard RBAC forbidden"
            assert rule["verbs"] != ["*"], "wildcard RBAC forbidden"
    assert docs == load_template("rbac.yaml", JAX_CHART)


def test_visible_chips_knob_is_wired_end_to_end(monkeypatch):
    """values -> env -> the port's plugin flag."""
    assert values()["kubeletPlugin"]["visibleChips"] == ""
    text = (CHART / "templates" / "kubeletplugin.yaml").read_text()
    assert 'value: "{{ .Values.kubeletPlugin.visibleChips }}"' in text
    from k8s_dra_driver_tpu_torch.cmd import plugin
    monkeypatch.setenv("VISIBLE_CHIPS", "@/visible_chips")
    assert plugin.build_parser().parse_args(
        ["--node-name", "n"]).visible_chips == "@/visible_chips"


def test_image_builds_the_shims_and_carries_no_torch():
    text = DOCKERFILE.read_text()
    assert "COPY k8s_dra_driver_tpu_torch ./k8s_dra_driver_tpu_torch" in text
    assert "k8s_dra_driver_tpu\n" not in text and \
        "COPY k8s_dra_driver_tpu " not in text, "the JAX package stays out"
    for lib in ("libtpudiscovery.so", "libtpualloc.so"):
        assert f"/src/build/native/{lib}" in text
    assert "TPU_DISCOVERY_LIB=/usr/local/lib/libtpudiscovery.so" in text
    assert "TPU_ALLOC_LIB=/usr/local/lib/libtpualloc.so" in text
    assert "torch" not in text.split("pip install")[1].split("\n")[0]
    assert '! python -c "import torch"' in text
    # the coordinator template's command exists in the image
    template = yaml.safe_load((REPO / PKG / "plugin" / "templates" /
                               "coordinator-daemon.yaml").read_text())
    cmd = template["spec"]["template"]["spec"]["containers"][0]["command"]
    assert cmd == ["tpu-coordinatord"]
    assert "/usr/local/bin/tpu-coordinatord" in text
    # every command the chart runs is smoke-checked in the image
    for module in ("cmd.plugin", "cmd.controller", "cmd.coordinatord"):
        assert f"python -m {PKG}.{module} --version" in text


@pytest.fixture(scope="module")
def no_torch(tmp_path_factory) -> Path:
    return torchless_image(tmp_path_factory.mktemp("image"))


@pytest.mark.parametrize("module,flag", [
    ("cmd.plugin", "--version"), ("cmd.controller", "--version"),
    ("cmd.coordinatord", "--version"), ("coordclient.gate", "--help")])
def test_image_smoke_checks_run_without_torch(no_torch, module, flag):
    """The image's smoke checks, here with torch unimportable: each
    command answers, and the version is the port's."""
    from k8s_dra_driver_tpu_torch.utils import info
    out = subprocess.run([sys.executable, "-m", f"{PKG}.{module}", flag],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=60, env={"PYTHONPATH": f"{no_torch}:{REPO}",
                                          "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    if flag == "--version":
        assert out.stdout.strip().startswith(info.version)


def h100_docs() -> dict[str, list[dict]]:
    return {p.name: [d for d in yaml.safe_load_all(p.read_text()) if d]
            for p in sorted(H100_SPECS.glob("*.yaml"))}


def test_h100_specs_parse_and_reference_claims():
    specs = h100_docs()
    assert sorted(specs) == sorted(
        f"{n}.yaml" for n in ("tpu-test1", "tpu-test2", "tpu-test3",
                              "tpu-test5", "tpu-test6",
                              "tpu-test-coordinator", "tpu-test-enforced",
                              "tpu-test-serve"))
    from k8s_dra_driver_tpu_torch.api.classes import standard_device_classes
    classes = set(standard_device_classes())
    for name, docs in specs.items():
        claims = {d["metadata"]["name"] for d in docs
                  if d["kind"] == "ResourceClaim"}
        templates = {d["metadata"]["name"] for d in docs
                     if d["kind"] == "ResourceClaimTemplate"}
        pods = [d for d in docs if d["kind"] == "Pod"]
        assert pods, f"{name}: no workloads"
        for spec in [d["spec"] for d in docs if d["kind"] == "ResourceClaim"
                     ] + [d["spec"]["spec"] for d in docs
                          if d["kind"] == "ResourceClaimTemplate"]:
            for req in spec["devices"]["requests"]:
                assert req["deviceClassName"] in classes
        for pod in pods:
            ps = pod["spec"]
            for ref in ps.get("resourceClaims", []):
                if "resourceClaimName" in ref:
                    assert ref["resourceClaimName"] in claims, name
                else:
                    assert ref["resourceClaimTemplateName"] in templates, \
                        name
            declared = {r["name"] for r in ps.get("resourceClaims", [])}
            for ctr in ps["containers"]:
                for c in ctr.get("resources", {}).get("claims", []):
                    assert c["name"] in declared, name


def test_h100_pod_scripts_are_valid_python():
    """Every H100 pod's script compiles, prints CUDA_VISIBLE_DEVICES and
    the /dev/nvidia* nodes, and guards its torch import."""
    for name, docs in h100_docs().items():
        for pod in (d for d in docs if d["kind"] == "Pod"):
            for ctr in pod["spec"]["containers"]:
                argv = ctr["command"] + ctr["args"]
                script = argv[argv.index("-c") + 1]
                ast.parse(script)
                assert "CUDA_VISIBLE_DEVICES" in script, name
                assert 'glob.glob("/dev/nvidia*")' in script, name
                assert "import torch" in script, name
                assert "TPU_VISIBLE_CHIPS" not in script, name
