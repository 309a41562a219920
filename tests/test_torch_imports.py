"""The PyTorch port stands alone: no module of k8s_dra_driver_tpu_torch,
nor its on-card scripts (chip_smoke.py, chip_profile.py,
chip_bwd_rounding.py), imports JAX
(jax, jaxlib, optax), ml_dtypes (the bfloat16 numpy type JAX brings
along), prometheus_client (absent on the card's machine; the port's
utils/metrics.py carries its own registry) or anything of the JAX
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
        ROOT / "chip_bwd_rounding.py"]


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
            "chip_bwd_rounding.py"} <= files
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
                "sim/rig.py", "sim/probe.py"):
        assert f"k8s_dra_driver_tpu_torch/{mod}" in files


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


def test_port_reads_its_own_fixtures():
    from k8s_dra_driver_tpu_torch.gateway import loadgen
    assert PORT in loadgen.TRACE_DIR.parents
    for name in loadgen.TRACE_NAMES:
        assert (loadgen.TRACE_DIR / f"{name}.json").is_file()
