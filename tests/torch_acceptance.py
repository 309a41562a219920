"""Helpers of the acceptance twins (tests/test_torch_e2e.py,
test_torch_demo_specs.py, test_torch_concurrency.py,
test_torch_chaos_oop.py, test_torch_deployments.py): the demo specs
loaded by kind, the port's own copy of ``tests/test_demo_specs.py``'s
``SpecRunner`` (its claims from the port's ``cluster/specs.py``, which
``chip_smoke.py`` applies the H100 specs with) for either package's
objects, the JAX
package's ``E2EBed`` on a short ``/tmp`` directory (unix socket paths
stop at 107 bytes, which a pytest basetemp can pass), and a pod's view
as a record the two packages' runs can be compared by: every bed root
written ``<ROOT>`` and every claim uid ``<uid:name>`` (each package
numbers its uids from its own counter); ``run_both`` runs one scenario
on both packages' beds and holds the outcomes equal; and a directory
that makes a child interpreter an image without torch."""

from __future__ import annotations

import shutil
from pathlib import Path

from k8s_dra_driver_tpu_torch.cluster import specs
from testbed import E2EBed
from torch_driver import JAX, PORT
from torch_plugin import short_dir
from torch_testbed import PortE2EBed

SPECS_ROOT = Path(__file__).resolve().parent.parent / "demo" / "specs"


def load(name: str, subdir: str = "quickstart") -> dict[str, list[dict]]:
    """A spec file's documents, grouped by kind."""
    return specs.load(SPECS_ROOT / subdir / name)


def load_many(subdir: str, *names: str) -> dict[str, list[dict]]:
    """Several spec files of one demo tree, merged by kind."""
    return specs.load(*(SPECS_ROOT / subdir / name for name in names))


class SpecRunner(specs.SpecClaims):
    """A spec's claims made on ``bed`` with the objects of ``resource``
    (either package's ``api.resource``), and its pods run as the
    kubelet would."""

    def __init__(self, bed, docs: dict[str, list[dict]], resource):
        self.bed = bed
        super().__init__(docs, bed.create_claim, resource)

    def run(self, pod: dict):
        """All of a pod's claims on one node: one view, or a list of
        views in resourceClaims order."""
        views = [self.bed.run_pod(c) for c in self.claims_for(pod)]
        return views[0] if len(views) == 1 else views


class JaxE2EBed(E2EBed):
    """The JAX package's ``E2EBed`` on a short ``/tmp`` directory, which
    ``shutdown`` removes."""

    def __init__(self, hosts, **kw):
        super().__init__(short_dir("je2e-"), hosts, **kw)

    def shutdown(self) -> None:
        super().shutdown()
        shutil.rmtree(self.tmp, ignore_errors=True)


def normalizer(bed, claims):
    """A function that writes ``bed``'s root as ``<ROOT>`` and each of
    ``claims``' uids as ``<uid:namespace/name>`` in a string."""
    root = str(bed.tmp)
    uids = {c.metadata.uid: f"<uid:{c.metadata.namespace}/"
            f"{c.metadata.name}>" for c in claims}

    def norm(s: str) -> str:
        s = s.replace(root, "<ROOT>")
        for uid, name in uids.items():
            s = s.replace(uid, name)
        return s
    return norm


def view_record(bed, view, claims) -> dict:
    """A pod's view (node, env, device nodes, mounts) with the bed's
    root and the claims' uids normalized."""
    norm = normalizer(bed, claims)
    return dict(
        node=view.node,
        env={k: norm(v) for k, v in sorted(view.env.items())},
        device_nodes=[norm(p) for p in view.device_nodes],
        mounts=[{k: (norm(v) if isinstance(v, str) else v)
                 for k, v in sorted(m.items())} for m in view.mounts])


def allocated(claim) -> list[tuple[str, str, str]]:
    """A claim's allocation as sorted (request, pool, device)."""
    alloc = claim.status.allocation
    if alloc is None:
        return []
    return sorted((x.request, x.pool, x.device) for x in alloc.results)


def deployments(bed, claims) -> list[str]:
    """The names of the bed's coordinator Deployments, uids normalized."""
    norm = normalizer(bed, claims)
    return sorted(norm(d.metadata.name)
                  for d in bed.cluster.list("Deployment"))


def run_both(hosts, scenario, **bed_kw):
    """``scenario(bed, pkg)`` on the JAX package's bed, then on the
    port's, each over ``hosts(pkg)`` and given ``bed_kw``; the two
    outcomes must be equal, and the port's is returned."""
    outs = []
    for pkg in (JAX, PORT):
        bed = (JaxE2EBed if pkg is JAX else PortE2EBed)(hosts(pkg), **bed_kw)
        try:
            outs.append(scenario(bed, pkg))
        finally:
            bed.shutdown()
    assert outs[1] == outs[0]
    return outs[1]


def chips(rec) -> list[int]:
    """A view record's ``TPU_VISIBLE_CHIPS`` as indices."""
    v = rec["env"].get("TPU_VISIBLE_CHIPS", "")
    return [int(x) for x in v.split(",") if x]


def torchless_image(root: Path) -> Path:
    """``root`` holding a ``torch`` package that fails to import: first
    on a child's ``PYTHONPATH``, it makes the child's interpreter an
    image without torch."""
    (root / "torch").mkdir()
    (root / "torch" / "__init__.py").write_text(
        'raise ImportError("torch is not in this image")\n')
    return root
