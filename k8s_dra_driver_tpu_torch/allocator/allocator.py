"""Structured-parameters allocator.

The port's copy of ``k8s_dra_driver_tpu/allocator/allocator.py``.  The
driver name stays ``tpu.google.com``; the search is device-agnostic.

Upstream Kubernetes performs claim allocation in the kube-scheduler
(SURVEY §3.2 — entry point #2 happens *outside* the reference repo).
This in-repo allocator implements the same contract so the full claim
lifecycle runs hermetically and in standalone deployments: match CEL
selectors from DeviceClasses and requests against published
ResourceSlice devices, respect shared capacity tokens (the overlap
model from devicemodel/), enforce matchAttribute constraints, pick a
node, and write the allocation + opaque-config passthrough into
claim.status — exactly the shape the kubelet plugin consumes.

Semantics of shared tokens: within one resource pool, every capacity
name for which ``devicemodel.is_shared_token`` holds is a single-supply
counter.  A device consumes its tokens when allocated; two devices that
share a token can never be simultaneously allocated.  This is the
scheduler-enforced-overlap contract the device model publishes
(the MIG memorySlice technique, reference deviceinfo.go:195-198).
"""

from __future__ import annotations

import dataclasses
import functools
import os

from ..api import resource
from ..cluster import Node, match_labels
from ..devicemodel import is_shared_token
from .cel import matches_selectors

DRIVER_NAME = "tpu.google.com"


class AllocationError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class _Candidate:
    device: resource.Device
    pool: str
    node_name: str                  # "" for cluster-scoped pools
    node_selector: tuple[tuple[str, str], ...] | None

    @functools.cached_property
    def tokens(self) -> frozenset[tuple[str, str]]:
        # cached: the DFS hot loop reads this twice per candidate per
        # expansion (conflict check + sibling signature)
        return frozenset((self.pool, name) for name in self.device.capacity
                         if is_shared_token(name))

    def key(self) -> tuple[str, str]:
        return (self.pool, self.device.name)


# Cap on search-tree expansions per node attempt. The DFS below prunes
# aggressively (incremental constraints, token conflicts, equivalent
# siblings), so realistic pools resolve in linear-ish work; the budget
# exists so an adversarial claim over a big pool (SURVEY hard part #1:
# shape-enumeration combinatorics) degrades to a clean AllocationError
# instead of an exponential hang.
DEFAULT_SEARCH_BUDGET = 100_000


class _BudgetExhausted(Exception):
    pass


class Allocator:
    """``engine`` selects the DFS implementation: "python" (default),
    "native" (the C++ core, the port's native/tpualloc.cc — errors if
    it cannot build/load), or "auto" (native with silent Python
    fallback).  Both engines are pick-identical by contract
    (tests/test_torch_native_alloc.py); TPU_ALLOC_ENGINE overrides the
    default for deployments."""

    def __init__(self, driver: str = DRIVER_NAME,
                 search_budget: int = DEFAULT_SEARCH_BUDGET,
                 engine: str | None = None):
        self.driver = driver
        self.search_budget = search_budget
        self.engine = engine or os.environ.get("TPU_ALLOC_ENGINE",
                                               "python")
        if self.engine not in ("python", "native", "auto"):
            raise ValueError(f"unknown allocator engine {self.engine!r}")

    # ------------------------------------------------------------------

    def allocate(
        self,
        claim: resource.ResourceClaim,
        slices: list[resource.ResourceSlice],
        classes: dict[str, resource.DeviceClass],
        nodes: list[Node] | None = None,
        allocated_claims: list[resource.ResourceClaim] | None = None,
    ) -> resource.AllocationResult:
        """Compute an allocation for ``claim`` or raise AllocationError."""
        slices = [s for s in slices if s.driver == self.driver]
        consumed = self._consumed_tokens(allocated_claims or [], slices)
        node_names = self._candidate_nodes(slices, nodes)
        nodes_by_name = {n.metadata.name: n for n in (nodes or [])}

        errors: list[str] = []
        for node_name in node_names:
            node = nodes_by_name.get(node_name)
            cands = self._accessible(slices, node_name, node)
            try:
                chosen = self._solve(claim, cands, classes, consumed)
            except AllocationError as e:
                errors.append(f"node {node_name}: {e}")
                continue
            return self._build_result(claim, chosen, classes, node_name)
        detail = "; ".join(errors) if errors else "no candidate nodes"
        raise AllocationError(
            f"cannot allocate claim {claim.metadata.name}: {detail}")

    # -- state ------------------------------------------------------------

    def _consumed_tokens(self, allocated: list[resource.ResourceClaim],
                         slices: list[resource.ResourceSlice]
                         ) -> set[tuple[str, str]]:
        by_key = {}
        for s in slices:
            for d in s.devices:
                by_key[(s.pool.name, d.name)] = d
        out: set[tuple[str, str]] = set()
        for claim in allocated:
            alloc = claim.status.allocation
            if alloc is None:
                continue
            for res in alloc.results:
                dev = by_key.get((res.pool, res.device))
                if dev is None:
                    continue
                out.update((res.pool, name) for name in dev.capacity
                           if is_shared_token(name))
        return out

    def _candidate_nodes(self, slices: list[resource.ResourceSlice],
                         nodes: list[Node] | None) -> list[str]:
        names = {s.node_name for s in slices if s.node_name}
        if nodes:
            names.update(n.metadata.name for n in nodes)
        return sorted(names)

    def _accessible(self, slices: list[resource.ResourceSlice],
                    node_name: str, node: Node | None) -> list[_Candidate]:
        out: list[_Candidate] = []
        for s in slices:
            if s.node_name:
                if s.node_name != node_name:
                    continue
                selector = None
            elif s.all_nodes:
                selector = None
            elif s.node_selector is not None:
                labels = node.metadata.labels if node else {}
                if not match_labels(labels, s.node_selector):
                    continue
                selector = tuple(sorted(s.node_selector.items()))
            else:
                continue
            for d in s.devices:
                out.append(_Candidate(
                    device=d, pool=s.pool.name,
                    node_name=s.node_name,
                    node_selector=selector))
        return out

    # -- search -----------------------------------------------------------

    def _solve(self, claim: resource.ResourceClaim,
               cands: list[_Candidate],
               classes: dict[str, resource.DeviceClass],
               consumed: set[tuple[str, str]]
               ) -> dict[str, list[_Candidate]]:
        requests = claim.spec.devices.requests
        if not requests:
            raise AllocationError("claim has no device requests")
        constraints = claim.spec.devices.constraints

        per_request: list[
            tuple[resource.DeviceRequest, list[_Candidate], list[str]]] = []
        for req in requests:
            eligible = [c for c in cands
                        if self._matches(req, c.device, classes)
                        and not (c.tokens & consumed)]
            # Prefer the least-blocking devices (fewest shared tokens):
            # a chip before a slice, a core before a chip. Secondary key
            # groups devices by their matchAttribute values so
            # constraint-compatible picks are adjacent and the DFS finds
            # (or refutes) a same-value group without roaming the pool.
            match_attrs = self._match_attrs_for(req.name, constraints)
            eligible.sort(key=lambda c: (
                len(c.tokens),
                tuple(str(c.device.attributes.get(a)) for a in match_attrs),
                c.device.name))
            if not eligible:
                raise AllocationError(
                    f"request {req.name!r}: no eligible devices")
            per_request.append((req, eligible, match_attrs))

        status, solution = "nosolution", None
        if self.engine in ("native", "auto"):
            status, solution = self._solve_native(per_request, constraints)
        if status == "unavailable" or self.engine == "python":
            budget = [self.search_budget]
            try:
                solution = self._search(per_request, 0, {}, set(),
                                        constraints, budget)
                status = "ok" if solution is not None else "nosolution"
            except _BudgetExhausted:
                status = "budget"

        # one raise site so the two engines can never report a shared
        # outcome differently
        if status == "budget":
            raise AllocationError(
                f"search budget ({self.search_budget} expansions) "
                "exhausted without a conflict-free combination; the "
                "claim is either unsatisfiable or adversarially "
                "symmetric for this pool")
        if solution is None:
            raise AllocationError(
                "no conflict-free device combination satisfies all "
                "requests and constraints")
        return solution

    def _solve_native(self, per_request, constraints):
        """Run the C++ search core; status "unavailable" means fall
        back to Python (only under engine="auto")."""
        from . import native as native_alloc
        try:
            return native_alloc.solve(per_request, constraints,
                                      self.search_budget)
        except native_alloc.NativeAllocUnavailableError:
            if self.engine == "auto":
                return "unavailable", None
            raise

    @staticmethod
    def _match_attrs_for(req_name, constraints) -> list[str]:
        return [con.match_attribute for con in constraints
                if con.match_attribute
                and (not con.requests or req_name in con.requests)]

    def _search(self, per_request, idx, chosen, used_tokens, constraints,
                budget):
        """Bounded DFS: one device at a time, constraints checked on
        every partial assignment (a violated matchAttribute can never
        be repaired by adding devices), token conflicts pruned inline,
        and equivalent failed siblings (same tokens + same constraint
        attributes) tried once.  Replaces the round-1
        ``itertools.combinations`` enumeration whose worst case was
        C(pool, count) (VERDICT weak #7)."""
        if idx == len(per_request):
            return dict(chosen)
        req, eligible, match_attrs = per_request[idx]
        free = [c for c in eligible if not (c.tokens & used_tokens)]

        if req.allocation_mode == resource.ALLOCATION_MODE_ALL:
            picked: list[_Candidate] = []
            tokens = set(used_tokens)
            for c in free:
                if c.tokens & tokens:
                    continue
                picked.append(c)
                tokens |= c.tokens
            if not picked:
                return None
            chosen[req.name] = picked
            if self._constraints_ok(chosen, constraints):
                result = self._search(per_request, idx + 1, chosen,
                                      tokens, constraints, budget)
                if result is not None:
                    return result
            del chosen[req.name]
            return None

        if req.count == 0:            # vacuous request allocates nothing
            chosen[req.name] = []
            result = self._search(per_request, idx + 1, chosen,
                                  used_tokens, constraints, budget)
            if result is None:
                del chosen[req.name]
            return result

        def sibling_sig(c: _Candidate):
            # Raw attribute values, not str(): _constraints_ok compares
            # raw values, so 1 and "1" must NOT share a signature or the
            # failed-sibling prune could skip a satisfying candidate.
            return (c.tokens, tuple(c.device.attributes.get(a)
                                    for a in match_attrs))

        def pick(start: int, partial: list[_Candidate], tokens):
            budget[0] -= 1
            if budget[0] < 0:
                raise _BudgetExhausted
            if len(partial) == req.count:
                result = self._search(per_request, idx + 1, chosen,
                                      used_tokens | tokens, constraints,
                                      budget)
                return result
            need = req.count - len(partial)
            failed_sigs = set()
            for j in range(start, len(free)):
                if len(free) - j < need:
                    break
                c = free[j]
                if c.tokens & tokens:
                    continue
                sig = sibling_sig(c)
                if sig in failed_sigs:
                    continue          # an identical sibling already failed
                partial.append(c)
                chosen[req.name] = partial
                if self._constraints_ok(chosen, constraints):
                    result = pick(j + 1, partial, tokens | c.tokens)
                    if result is not None:
                        return result
                partial.pop()
                failed_sigs.add(sig)
            return None

        if len(free) < req.count:
            return None
        result = pick(0, [], set())
        if result is None:
            chosen.pop(req.name, None)
        return result

    def _matches(self, req: resource.DeviceRequest, device: resource.Device,
                 classes: dict[str, resource.DeviceClass]) -> bool:
        if req.device_class_name:
            cls = classes.get(req.device_class_name)
            if cls is None:
                raise AllocationError(
                    f"request {req.name!r}: unknown device class "
                    f"{req.device_class_name!r}")
            if not matches_selectors(device, cls.selectors, self.driver):
                return False
        return matches_selectors(device, req.selectors, self.driver)

    def _constraints_ok(self, chosen: dict[str, list[_Candidate]],
                        constraints: list[resource.DeviceConstraint]) -> bool:
        for con in constraints:
            if not con.match_attribute:
                continue
            values = set()
            scope = con.requests or list(chosen.keys())
            for req_name in scope:
                for c in chosen.get(req_name, []):
                    v = c.device.attributes.get(con.match_attribute)
                    if v is None:
                        return False
                    values.add(v)
            if len(values) > 1:
                return False
        return True

    # -- result -----------------------------------------------------------

    def _build_result(self, claim: resource.ResourceClaim,
                      chosen: dict[str, list[_Candidate]],
                      classes: dict[str, resource.DeviceClass],
                      node_name: str) -> resource.AllocationResult:
        results = []
        selector: dict[str, str] | None = None
        pin_to_node = False
        for req in claim.spec.devices.requests:
            for c in chosen[req.name]:
                results.append(resource.DeviceRequestAllocationResult(
                    request=req.name, driver=self.driver, pool=c.pool,
                    device=c.device.name))
                if c.node_name:
                    pin_to_node = True
                elif c.node_selector and selector is None:
                    selector = dict(c.node_selector)
        if pin_to_node:
            selector = {"kubernetes.io/hostname": node_name}

        config: list[resource.AllocatedDeviceConfig] = []
        # Class configs first (lower precedence), scoped to the requests
        # that used the class — then claim configs verbatim
        # (the source ordering DeviceState's resolution relies on,
        # reference device_state.go:457-510).
        for req in claim.spec.devices.requests:
            cls = classes.get(req.device_class_name)
            if cls is None:
                continue
            for cc in cls.config:
                if cc.opaque is not None:
                    config.append(resource.AllocatedDeviceConfig(
                        source=resource.CONFIG_SOURCE_CLASS,
                        requests=[req.name], opaque=cc.opaque))
        for cc in claim.spec.devices.config:
            if cc.opaque is not None:
                config.append(resource.AllocatedDeviceConfig(
                    source=resource.CONFIG_SOURCE_CLAIM,
                    requests=list(cc.requests), opaque=cc.opaque))

        return resource.AllocationResult(
            results=results, config=config, node_selector=selector)
