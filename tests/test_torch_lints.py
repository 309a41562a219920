"""The repo's four static lints over the port (k8s_dra_driver_tpu_torch),
through each tool's own functions and with tools/ unchanged: the JAX
package's gates (test_deadlines_lint.py, test_perf_claims.py,
test_metrics_docs.py, test_shardings_lint.py) with their scope switched
to the port.

- deadlines: every blocking wait in the port takes a deadline or says
  why not in a ``# deadline:`` comment;
- perf claims: the port's twins of the JAX package's scoped tiers cite
  a tools/*.json that exists for every perf-shaped number;
- metrics docs: the port's registries, rendered as its ``/metrics``
  serves them, against docs/OBSERVABILITY.md in both directions;
- shardings: no spec is built in the port's ``models/`` outside
  ``models/layouts.py``, the port's own ``P``/``PartitionSpec``
  (parallel/mesh.py) tracked through its imports.

Each gate asserts an empty problem list.
"""

import ast
import re
import sys
import textwrap
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent.parent / "tools"))

import lint_deadlines  # noqa: E402
import lint_metrics_docs  # noqa: E402
import lint_perf_claims  # noqa: E402
import lint_shardings  # noqa: E402

PORT = "k8s_dra_driver_tpu_torch"
JAX = "k8s_dra_driver_tpu"


def port_scopes(scopes) -> tuple:
    """The port's twin of each of the JAX package's scope paths."""
    return tuple(PORT + s[len(JAX):] for s in scopes)


# --------------------------------------------------------------------------
# deadlines
# --------------------------------------------------------------------------

def test_port_blocking_waits_all_carry_deadlines(monkeypatch):
    """THE gate: the deadlines lint over the whole port."""
    monkeypatch.setattr(lint_deadlines, "SCOPES", (PORT,))
    problems = lint_deadlines.lint()
    assert problems == [], "\n".join(problems)


def test_deadline_lint_sees_the_port(monkeypatch, tmp_path):
    """The switched scope reaches a nested port module."""
    mod = tmp_path / PORT / "parallel"
    mod.mkdir(parents=True)
    (mod / "x.py").write_text("def f(work):\n    work.wait()\n")
    monkeypatch.setattr(lint_deadlines, "SCOPES", (PORT,))
    problems = lint_deadlines.lint(tmp_path)
    assert len(problems) == 1 and "parallel/x.py:2" in problems[0]


# --------------------------------------------------------------------------
# perf claims
# --------------------------------------------------------------------------

def test_port_perf_claims_are_cited(monkeypatch):
    """THE gate: every perf-shaped number in the port's scoped
    docstrings cites a tools/*.json that exists and parses."""
    scopes = port_scopes(lint_perf_claims.SCOPES)
    for scope in scopes:
        assert (lint_perf_claims.REPO / scope).is_dir(), scope
    monkeypatch.setattr(lint_perf_claims, "SCOPES", scopes)
    problems = lint_perf_claims.lint()
    assert problems == [], "\n".join(problems)


def test_procprobe_artifact_carries_the_card():
    """The multi-process probe's artifact, cited by its module, was
    written on the card and says which card, at which power limit."""
    import json
    doc = ast.get_docstring(ast.parse(
        (lint_perf_claims.REPO / PORT / "gateway/procprobe.py").read_text()))
    cites = lint_perf_claims.ARTIFACT_RE.findall(doc)
    assert cites == ["tools/ctl_multiproc_torch.json"]
    art = json.loads((lint_perf_claims.REPO / cites[0]).read_text())
    assert art["device"].startswith("cuda")
    assert re.fullmatch(r".*H100.*, \d+\.\d+ W", art["card"]), art["card"]


# --------------------------------------------------------------------------
# metrics docs
# --------------------------------------------------------------------------

def port_live_series() -> dict[str, str]:
    """name -> kind for every series the port's registries (and its
    MemWatch ledger, on the host) export: what its ``/metrics`` serves."""
    from k8s_dra_driver_tpu_torch.utils.memwatch import MemWatch
    from k8s_dra_driver_tpu_torch.utils.metrics import (DriverMetrics,
                                                        FleetMetrics,
                                                        GatewayMetrics,
                                                        RecoveryMetrics,
                                                        render_all)
    text = render_all(DriverMetrics(), GatewayMetrics(), RecoveryMetrics(),
                      FleetMetrics(), MemWatch(device="cpu")).decode()
    return {name: kind
            for name, kind in re.findall(r"^# TYPE (\S+) (\S+)", text, re.M)
            if not name.endswith("_created")}


def test_port_metrics_and_docs_agree(monkeypatch):
    """THE gate: the port's live series against docs/OBSERVABILITY.md,
    both directions, by the tool's own comparison."""
    monkeypatch.setattr(lint_metrics_docs, "live_series", port_live_series)
    problems = lint_metrics_docs.lint()
    assert problems == [], "\n".join(problems)


def test_port_roster_has_every_prefix():
    """A registry missing from the port's roster would shrink what the
    doc is held to."""
    live = port_live_series()
    assert {n.split("_")[1] for n in live} >= {"dra", "gateway", "train",
                                               "fleet", "mem"}


def test_port_undocumented_series_is_flagged(monkeypatch, tmp_path):
    doc = tmp_path / "OBSERVABILITY.md"
    doc.write_text(lint_metrics_docs.DOC.read_text().replace(
        "tpu_gateway_queue_depth", "(gone)"))
    monkeypatch.setattr(lint_metrics_docs, "live_series", port_live_series)
    problems = lint_metrics_docs.lint(doc)
    assert len(problems) == 1 and "tpu_gateway_queue_depth" in problems[0]


# --------------------------------------------------------------------------
# shardings
# --------------------------------------------------------------------------

_PORT_TARGETS = lint_shardings._TARGETS + ("P",)
_TOOL_ALIASES = lint_shardings._alias_table


def port_alias_table(tree: ast.AST) -> dict[str, str]:
    """The tool's alias table, plus the port's own spec: ``P`` and
    ``PartitionSpec`` imported from its parallel package (any alias),
    and that package or its mesh module imported as a module."""
    aliases = _TOOL_ALIASES(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            for a in node.names:
                if a.name in ("P", "PartitionSpec") and module.endswith(
                        ("parallel", "parallel.mesh")):
                    aliases[a.asname or a.name] = "PartitionSpec"
                elif a.name in ("mesh", "parallel"):
                    aliases[a.asname or a.name] = "@module"
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(PORT + ".parallel"):
                    aliases[(a.asname or a.name).split(".")[0]] = "@module"
    return aliases


@pytest.fixture
def port_shardings(monkeypatch):
    monkeypatch.setattr(lint_shardings, "SCOPE", Path(PORT) / "models")
    monkeypatch.setattr(lint_shardings, "_TARGETS", _PORT_TARGETS)
    monkeypatch.setattr(lint_shardings, "_alias_table", port_alias_table)
    return lint_shardings


def test_port_models_build_no_spec_outside_layouts(port_shardings):
    """THE gate: no naked spec in the port's models/ outside
    layouts.py."""
    problems = port_shardings.lint()
    assert problems == [], "\n".join(problems)


def test_port_layouts_module_builds_the_specs(port_shardings):
    """The rules table is where the specs are: the lint, were it not
    exempt, would find them there (so the gate above is not vacuous)."""
    path = port_shardings.REPO / PORT / "models" / "layouts.py"
    assert len(port_shardings.lint_file(path)) > 10


def _scratch(tmp_path, body, name="fake.py"):
    mod = tmp_path / PORT / "models"
    mod.mkdir(parents=True)
    (mod / name).write_text(textwrap.dedent(body))
    return tmp_path


SCRATCH = {
    "relative_P": ('''
        from ..parallel.mesh import P
        def f():
            return P("tp", None)
    ''', 1),
    "aliased_PartitionSpec": ('''
        from k8s_dra_driver_tpu_torch.parallel import PartitionSpec as Spec
        def f():
            return Spec(None, "tp")
    ''', 1),
    "module_attribute": ('''
        from ..parallel import mesh
        import k8s_dra_driver_tpu_torch.parallel.mesh as pm
        def f():
            return mesh.P("tp"), pm.PartitionSpec(None)
    ''', 2),
    "layout_comment_exempts": ('''
        from ..parallel.mesh import P
        def f():
            b = P("dp", None)  # layout: input batch, not a parameter
            # layout: replicated counters
            return b, P()
    ''', 0),
    "unrelated_comment_does_not": ('''
        from ..parallel.mesh import P
        def f():
            # shard over tp
            return P("tp")
    ''', 1),
}


@pytest.mark.parametrize("name", sorted(SCRATCH))
def test_port_shardings_lint_tracks_the_ports_spec(port_shardings,
                                                   tmp_path, name):
    body, want = SCRATCH[name]
    assert len(port_shardings.lint(_scratch(tmp_path, body))) == want


def test_port_layouts_module_itself_is_exempt(port_shardings, tmp_path):
    repo = _scratch(tmp_path, '''
        from ..parallel.mesh import P
        TABLE = [("wq", P(None, "tp"))]
    ''', name="layouts.py")
    assert port_shardings.lint(repo) == []
