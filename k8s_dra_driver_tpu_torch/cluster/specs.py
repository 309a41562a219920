"""A demo spec's documents as the API server and the claim controller
see them: the documents of its files grouped by kind, its ResourceClaims
created, and, for each pod that names a ResourceClaimTemplate, a claim
of its own named ``<pod>-<claim ref>`` as the claim controller names it.

Written once for either package's API objects (``resource``, an
``api.resource`` module; the port's by default), so a spec can be run
through both and the outcomes compared.  Imports no torch."""

from __future__ import annotations

from pathlib import Path
from typing import Callable


def load(*paths) -> dict[str, list[dict]]:
    """The documents of the spec files at ``paths``, grouped by kind, in
    file order."""
    import yaml
    out: dict[str, list[dict]] = {}
    for path in paths:
        for doc in yaml.safe_load_all(Path(path).read_text()):
            if doc:
                out.setdefault(doc["kind"], []).append(doc)
    return out


class SpecClaims:
    """A spec's claims, each made by ``create`` (a ResourceClaim in,
    the stored claim out, as a cluster's ``create``): the spec's own
    ResourceClaims at once, a template's claim for a pod on
    :meth:`claims_for`."""

    def __init__(self, docs: dict[str, list[dict]], create: Callable,
                 resource=None):
        if resource is None:
            from ..api import resource
        self.resource = resource
        self.create = create
        self.templates = {t["metadata"]["name"]: t
                          for t in docs.get("ResourceClaimTemplate", [])}
        #: the spec's ResourceClaims by name
        self.shared = {}
        #: every claim made, in order
        self.claims = []
        for c in docs.get("ResourceClaim", []):
            claim = self._create(c["metadata"]["name"],
                                 c["metadata"].get("namespace", "default"),
                                 c["spec"])
            self.shared[claim.metadata.name] = claim
        self.pods = docs.get("Pod", [])

    def _create(self, name: str, namespace: str, spec: dict):
        r = self.resource
        claim = self.create(r.ResourceClaim(
            metadata=r.ObjectMeta(name=name, namespace=namespace),
            spec=r.from_dict(r.ResourceClaimSpec, spec)))
        self.claims.append(claim)
        return claim

    def from_template(self, name: str, template: str, namespace: str):
        return self._create(name, namespace,
                            self.templates[template]["spec"]["spec"])

    def claims_for(self, pod: dict) -> list:
        """A pod's resourceClaims in order: a template makes a claim for
        the pod, a name resolves to the spec's claim."""
        out = []
        for ref in pod["spec"].get("resourceClaims", []):
            if "resourceClaimName" in ref:
                out.append(self.shared[ref["resourceClaimName"]])
            else:
                out.append(self.from_template(
                    f"{pod['metadata']['name']}-{ref['name']}",
                    ref["resourceClaimTemplateName"],
                    pod["metadata"].get("namespace", "default")))
        return out
