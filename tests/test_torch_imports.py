"""The PyTorch port stands alone: no module of k8s_dra_driver_tpu_torch,
nor its on-card scripts (chip_smoke.py, chip_profile.py,
chip_bwd_rounding.py, chip_coord_probe.py), imports JAX
(jax, jaxlib, optax), ml_dtypes (the bfloat16 numpy type JAX brings
along), prometheus_client (the port's utils/metrics.py carries its own
registry, as the card's machine has not always had the package) or
anything of the JAX
package k8s_dra_driver_tpu — not even its numpy-only modules.  A static
AST scan, so imports hidden inside functions are caught too.  The
multi-process gateway starts its pumps with ``python -m <module>`` and
reads trace fixtures from disk: no string in the port names a module of
the JAX package, and the fixtures it reads are its own."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "k8s_dra_driver_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "k8s_dra_driver_tpu", "ml_dtypes",
             "prometheus_client")


def scanned_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_profile.py",
        ROOT / "chip_bwd_rounding.py", ROOT / "chip_coord_probe.py"]


def imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_scan_covers_the_port():
    files = {p.relative_to(ROOT).as_posix() for p in scanned_files()}
    assert {"chip_smoke.py", "chip_profile.py",
            "chip_bwd_rounding.py", "chip_coord_probe.py"} <= files
    for mod in ("models/serving.py", "models/decode.py",
                "models/transformer.py", "models/data.py",
                "models/checkpoint.py", "models/quant.py",
                "models/convert.py", "models/speculative.py",
                "models/specprobe.py", "ops/flash_attention.py",
                "ops/gmm.py", "ops/paged_attention.py",
                "ops/ring_attention.py", "ops/ulysses_attention.py",
                "parallel/mesh.py", "parallel/rendezvous.py",
                "serving_kv/manager.py", "serving_kv/tiers.py",
                "serving_kv/tierprobe.py", "serving_lora/pool.py",
                "serving_lora/probe.py",
                "utils/dispatch.py", "utils/atomicio.py",
                "cluster/bus.py", "utils/tracing.py", "utils/digest.py",
                "utils/metrics.py", "gateway/admission.py",
                "gateway/router.py", "gateway/replica.py",
                "gateway/frontend.py", "gateway/calibrate.py",
                "gateway/probe.py", "serving_disagg/index.py",
                "serving_disagg/migrate.py", "serving_disagg/pool.py",
                "serving_disagg/router.py", "serving_disagg/probe.py",
                "serving_disagg/wirekv.py", "gateway/wire.py",
                "gateway/outcome_store.py", "gateway/sharded.py",
                "gateway/ctlprobe.py", "gateway/loadgen.py",
                "gateway/procpump.py", "gateway/procprobe.py",
                "cluster/faults.py", "cluster/client.py",
                "cluster/invariants.py", "cluster/flightrec.py",
                "cluster/crucible.py", "cluster/chaosprobe.py",
                "coordclient/client.py",
                "utils/backoff.py", "sim/clock.py",
                "gateway/burnrate.py", "gateway/obsprobe.py",
                "utils/memwatch.py", "utils/httpendpoint.py",
                "serving_kv/probe.py", "fleet/__init__.py",
                "fleet/policy.py", "fleet/supply.py", "fleet/binpack.py",
                "fleet/reconciler.py", "fleet/tenancy.py",
                "fleet/probe.py", "utils/watchdog.py",
                "models/layouts.py", "parallel/resharding.py",
                "parallel/supervisor.py", "parallel/probe.py",
                "parallel/__init__.py", "ops/autotune.py",
                "ops/collectives.py", "utils/profiling.py",
                "sim/__init__.py", "sim/workload.py", "sim/fleet.py",
                "sim/rig.py", "sim/probe.py",
                "utils/nativebuild.py", "utils/quantity.py",
                "discovery/__init__.py", "discovery/topology.py",
                "discovery/types.py", "discovery/sysfs.py",
                "discovery/mask.py", "discovery/fake.py",
                "discovery/native.py", "api/__init__.py",
                "api/resource.py", "api/classes.py",
                "api/config/__init__.py", "api/config/v1alpha1/__init__.py",
                "api/config/v1alpha1/sharing.py",
                "api/config/v1alpha1/types.py",
                "api/config/v1alpha1/decoder.py", "cluster/objects.py",
                "devicemodel/__init__.py", "devicemodel/model.py",
                "devicemodel/prepared.py", "allocator/__init__.py",
                "allocator/cel.py", "allocator/allocator.py",
                "allocator/scheduler.py", "allocator/native.py",
                "discovery/probe.py", "proto/__init__.py",
                "proto/dra_pb2.py", "proto/registration_pb2.py",
                "proto/services.py", "utils/files.py", "utils/info.py",
                "utils/flags.py", "cluster/rest.py", "plugin/__init__.py",
                "plugin/cdi.py", "plugin/cdi_schema.py",
                "plugin/checkpoint.py", "plugin/sharing.py",
                "plugin/device_state.py", "plugin/publisher.py",
                "plugin/driver.py", "plugin/health.py", "cmd/__init__.py",
                "cmd/plugin.py", "coordclient/__init__.py",
                "coordclient/schedule.py", "coordclient/gate.py",
                "cmd/coordinatord.py", "cmd/controller.py",
                "controller/__init__.py", "controller/slices.py",
                "cluster/specs.py"):
        assert f"k8s_dra_driver_tpu_torch/{mod}" in files


def test_every_jax_module_has_a_port_but_the_shims():
    """File by file, the port has every module of the JAX package but
    the three JAX shims (compilation cache, CPU-process env, jax
    version compatibility), which need no port."""
    jax_pkg = ROOT / "k8s_dra_driver_tpu"
    missing = sorted(
        p.relative_to(jax_pkg).as_posix() for p in jax_pkg.rglob("*.py")
        if not (PORT / p.relative_to(jax_pkg)).is_file())
    assert missing == ["utils/compcache.py", "utils/cpuproc.py",
                       "utils/jax_compat.py"]


#: the JAX package's public names that need no port, by module (the
#: three JAX shims have no module at all, above), each with its reason
JAX_ONLY_NAMES = {
    "allocator/native.py": {
        "NATIVE_DIR": "the JAX package's shim build directory; the port "
                      "builds its shims into build/native/ (ROADMAP "
                      "Queue C item 35)"},
    "discovery/native.py": {
        "NATIVE_DIR": "as allocator/native.py's"},
    "models/decode.py": {
        "KVCache.tree_flatten": "JAX pytree registration",
        "KVCache.tree_unflatten": "JAX pytree registration"},
    "models/quant.py": {
        "QTensor.tree_flatten": "JAX pytree registration",
        "QTensor.tree_unflatten": "JAX pytree registration"},
    "ops/ring_attention.py": {
        "sharded_attention_call": "a shard_map call; the port runs one "
                                  "process a mesh position"},
    "parallel/mesh.py": {
        "batch_sharding": "a JAX NamedSharding",
        "replicated": "a JAX NamedSharding",
        "mesh_platform": "the platform of JAX devices"},
}


def public_names(path: Path) -> set[str]:
    """A module's public top-level names (functions, classes, assigned
    names) and its public classes' public methods as ``Class.method``."""
    out = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{sub.name}" for sub in node.body
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))}
        elif isinstance(node, ast.Assign):
            out |= {n.id for t in node.targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)):
            out.add(node.target.id)
    return {n for n in out
            if not any(part.startswith("_") for part in n.split("."))}


def test_every_public_jax_name_has_a_port():
    """Name by name: every public top-level name and public method of a
    JAX module is in the port's module of the same path, but the
    JAX-only names of JAX_ONLY_NAMES, which are all still in the JAX
    package and all still missing from the port."""
    jax_pkg = ROOT / "k8s_dra_driver_tpu"
    missing = {}
    for path in sorted(jax_pkg.rglob("*.py")):
        rel = path.relative_to(jax_pkg).as_posix()
        if not (PORT / rel).is_file():
            continue                  # the shims: the test above
        gone = public_names(path) - public_names(PORT / rel)
        if gone:
            missing[rel] = gone
    assert missing == {mod: set(names)
                       for mod, names in JAX_ONLY_NAMES.items()}
    assert all(reason for names in JAX_ONLY_NAMES.values()
               for reason in names.values())


def test_public_names_sees_methods_and_assignments(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("A = 1\n_b = 2\nc: int = 3\nx, (y, _z) = 1, (2, 3)\n"
                   "def f(): pass\nclass K:\n    def m(self): pass\n"
                   "    def _p(self): pass\nclass _H:\n    def q(self): "
                   "pass\n")
    assert public_names(src) == {"A", "c", "x", "y", "f", "K", "K.m"}


@pytest.mark.parametrize("module", [
    "k8s_dra_driver_tpu_torch.cmd.controller",
    "k8s_dra_driver_tpu_torch.cmd.coordinatord",
    "k8s_dra_driver_tpu_torch.coordclient.gate"])
def test_daemon_import_graphs_load_no_torch(module):
    """The controller, the coordinator daemon and the gate start before
    (or beside) any workload: their import graphs load neither torch nor
    jax, and nothing of the JAX package."""
    import subprocess
    import sys
    probe = (f"import sys, {module}; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'jaxlib', 'k8s_dra_driver_tpu')))")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


@pytest.mark.parametrize("path", scanned_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [n for n in imported_modules(path) if forbidden(n)]
    assert not bad, f"{path.name} imports {bad}"


def test_scanner_catches_forbidden_forms(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\n"
                   "def f():\n"
                   "    import jax.numpy as jnp\n"
                   "    from k8s_dra_driver_tpu.serving_kv import manager\n"
                   "    importlib.import_module('optax')\n"
                   "    from prometheus_client import Counter\n"
                   "from k8s_dra_driver_tpu_torch.models import decode\n")
    bad = [n for n in imported_modules(src) if forbidden(n)]
    assert sorted(bad) == ["jax.numpy", "k8s_dra_driver_tpu.serving_kv",
                           "optax", "prometheus_client"]


def module_strings(path: Path) -> list[str]:
    """String constants that are whole dotted module names of the JAX
    package (what ``python -m`` or ``import_module`` would load)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and re.fullmatch(r"k8s_dra_driver_tpu(\.\w+)+", n.value)]


def test_no_jax_module_strings():
    """The pump workers are the port's own module, and no other string
    names a JAX package module to spawn."""
    bad = {p.relative_to(ROOT).as_posix(): module_strings(p)
           for p in scanned_files() if module_strings(p)}
    assert not bad, bad
    src = (PORT / "gateway" / "procpump.py").read_text()
    assert '"k8s_dra_driver_tpu_torch.gateway.procpump"' in src


def native_sources():
    return sorted((PORT / "native").glob("*.cc"))


def test_native_sources_stay_in_the_port():
    """The port's C++ shims are its own: the wrappers build them from
    ``k8s_dra_driver_tpu_torch/native/`` into ``build/native/``, and no
    source names a path into the JAX package or its ``native/``
    directory (its sources, its Makefile, its ``native/build/``)."""
    names = {p.name for p in native_sources()}
    assert {"tpudiscovery.cc", "tpualloc.cc", "fakenvidia.cc"} <= names
    jax_path = re.compile(r"k8s_dra_driver_tpu/|(?<![\w/])native/")
    bad = {p.name: jax_path.findall(p.read_text())
           for p in native_sources() if jax_path.search(p.read_text())}
    assert not bad, bad
    from k8s_dra_driver_tpu_torch.utils import nativebuild
    assert nativebuild.NATIVE_DIR == PORT / "native"
    assert nativebuild.BUILD_DIR == ROOT / "build" / "native"


def test_port_reads_its_own_fixtures():
    from k8s_dra_driver_tpu_torch.gateway import loadgen
    assert PORT in loadgen.TRACE_DIR.parents
    for name in loadgen.TRACE_NAMES:
        assert (loadgen.TRACE_DIR / f"{name}.json").is_file()
