"""Real-cluster backend: a dependency-free Kubernetes REST client.

The port's copy of ``k8s_dra_driver_tpu/cluster/rest.py``, whole.  The
reference reaches the API server through client-go clientsets and
informers (vendored, ~MBs); this is the equivalent, sized to
the driver's actual needs: typed CRUD + list/watch for the six kinds the
driver touches, in-cluster or kubeconfig auth, QPS/burst rate limiting
(reference pkg/flags/kubeclient.go:49-64), and informer-style watches
with automatic relist/re-watch on disconnect (client-go reflector
behaviour, which the vendored resourceslice controller relies on —
reference vendor/.../resourceslicecontroller.go:123).

Wire format notes:
- ``ResourceSlice`` devices are published as ``{name, basic:
  {attributes, capacity}}`` per resource.k8s.io/v1alpha3, with typed
  attribute values ({"string":…}/{"int":…}/{"bool":…}) and capacities as
  quantity strings.
- node_selector label maps become v1.NodeSelector matchExpressions.
"""

from __future__ import annotations

import atexit
import base64
import copy
import json
import logging
import shutil
import ssl
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from urllib.parse import quote
from typing import Any, Callable

from ..api import resource
from ..utils.backoff import Backoff
from ..utils.flags import TokenBucket
from ..utils.quantity import format_quantity as _quantity_to_wire
from ..utils.quantity import parse_quantity as _quantity_from_wire
from .client import (ApiServerError, ApiUnavailableError, ClusterClient,
                     ConflictError, NotFoundError, WatchHandler,
                     match_labels)
from .objects import Deployment, Node, Pod

log = logging.getLogger(__name__)

SA_DIR = Path("/var/run/secrets/kubernetes.io/serviceaccount")

RESOURCE_API = "resource.k8s.io/v1alpha3"

# kind -> (apiVersion, plural, namespaced)
_KINDS = {
    "ResourceSlice": (RESOURCE_API, "resourceslices", False),
    "ResourceClaim": (RESOURCE_API, "resourceclaims", True),
    "DeviceClass": (RESOURCE_API, "deviceclasses", False),
    "Node": ("v1", "nodes", False),
    "Pod": ("v1", "pods", True),
    "Deployment": ("apps/v1", "deployments", True),
}


# --------------------------------------------------------------------------
# wire <-> dataclass conversion
# --------------------------------------------------------------------------

def _attr_to_wire(v: resource.AttrValue) -> dict:
    if isinstance(v, bool):
        return {"bool": v}
    if isinstance(v, int):
        return {"int": v}
    return {"string": str(v)}


def _attr_from_wire(d: dict) -> resource.AttrValue:
    for k in ("string", "int", "bool", "version"):
        if k in d:
            return d[k]
    return ""


def _meta_to_wire(m: resource.ObjectMeta) -> dict:
    out: dict[str, Any] = {"name": m.name}
    if m.namespace:
        out["namespace"] = m.namespace
    # uid is deliberately never sent: it is server-authoritative and
    # immutable — a real API server preserves it on sparse PUTs and
    # rejects a mismatched one (422), which the apply() upsert path
    # would trip over since locally constructed objects carry a fresh
    # client-side uid.
    if m.labels:
        out["labels"] = m.labels
    if m.annotations:
        out["annotations"] = m.annotations
    if m.resource_version:
        out["resourceVersion"] = str(m.resource_version)
    if m.owner_references:
        out["ownerReferences"] = [
            {"apiVersion": o.api_version, "kind": o.kind, "name": o.name,
             "uid": o.uid} for o in m.owner_references]
    return out


def _meta_from_wire(d: dict) -> resource.ObjectMeta:
    m = resource.ObjectMeta(
        name=d.get("name", ""), namespace=d.get("namespace", ""),
        uid=d.get("uid", ""), labels=d.get("labels") or {},
        annotations=d.get("annotations") or {})
    rv = d.get("resourceVersion", "0")
    m.resource_version = int(rv) if str(rv).isdigit() else 0
    m.owner_references = [
        resource.OwnerReference(api_version=o.get("apiVersion", ""),
                                kind=o.get("kind", ""),
                                name=o.get("name", ""),
                                uid=o.get("uid", ""))
        for o in d.get("ownerReferences", [])]
    return m


def _label_map_to_node_selector(labels: dict[str, str]) -> dict:
    return {"nodeSelectorTerms": [{
        "matchExpressions": [
            {"key": k, "operator": "In", "values": [v]}
            for k, v in sorted(labels.items())]}]}


def _node_selector_to_label_map(sel: dict) -> dict[str, str]:
    out: dict[str, str] = {}
    for term in sel.get("nodeSelectorTerms", []):
        for expr in term.get("matchExpressions", []):
            if expr.get("operator") == "In" and expr.get("values"):
                out[expr["key"]] = expr["values"][0]
    return out


def _slice_to_wire(s: resource.ResourceSlice) -> dict:
    spec: dict[str, Any] = {
        "driver": s.driver,
        "pool": {"name": s.pool.name, "generation": s.pool.generation,
                 "resourceSliceCount": s.pool.resource_slice_count},
        "devices": [{
            "name": d.name,
            "basic": {
                "attributes": {k: _attr_to_wire(v)
                               for k, v in d.attributes.items()},
                "capacity": {k: {"value": _quantity_to_wire(v)}
                             for k, v in d.capacity.items()},
            }} for d in s.devices],
    }
    if s.node_name:
        spec["nodeName"] = s.node_name
    elif s.node_selector:
        spec["nodeSelector"] = _label_map_to_node_selector(s.node_selector)
    elif s.all_nodes:
        spec["allNodes"] = True
    return {"apiVersion": RESOURCE_API, "kind": "ResourceSlice",
            "metadata": _meta_to_wire(s.metadata), "spec": spec}


def _slice_from_wire(d: dict) -> resource.ResourceSlice:
    spec = d.get("spec", {})
    devices = []
    for dev in spec.get("devices", []):
        basic = dev.get("basic", dev)
        devices.append(resource.Device(
            name=dev.get("name", ""),
            attributes={k: _attr_from_wire(v)
                        for k, v in basic.get("attributes", {}).items()},
            capacity={k: _quantity_from_wire(
                          v["value"] if isinstance(v, dict) else v)
                      for k, v in basic.get("capacity", {}).items()}))
    node_selector = None
    if spec.get("nodeSelector"):
        node_selector = _node_selector_to_label_map(spec["nodeSelector"])
    pool = spec.get("pool", {})
    return resource.ResourceSlice(
        metadata=_meta_from_wire(d.get("metadata", {})),
        driver=spec.get("driver", ""),
        pool=resource.ResourcePool(
            name=pool.get("name", ""),
            generation=pool.get("generation", 1),
            resource_slice_count=pool.get("resourceSliceCount", 1)),
        node_name=spec.get("nodeName", ""),
        node_selector=node_selector,
        all_nodes=spec.get("allNodes", False),
        devices=devices)


def _claim_from_wire(d: dict) -> resource.ResourceClaim:
    claim = resource.from_dict(resource.ResourceClaim, d)
    claim.metadata = _meta_from_wire(d.get("metadata", {}))
    alloc = claim.status.allocation if claim.status else None
    if alloc is not None and isinstance(alloc.node_selector, dict) \
            and "nodeSelectorTerms" in alloc.node_selector:
        alloc.node_selector = _node_selector_to_label_map(
            alloc.node_selector)
    return claim


def _wrap_cel_selectors(selectors: list) -> None:
    """In-place: flat `cel: "expr"` → upstream `cel: {expression}`."""
    for sel in selectors:
        if isinstance(sel.get("cel"), str):
            sel["cel"] = {"expression": sel["cel"]}


def _claim_to_wire(c: resource.ResourceClaim) -> dict:
    """Main-resource body: spec only — a real API server strips status
    from writes to the main resource (it is a subresource); see
    RestClusterClient.update for the /status write."""
    out = resource.to_dict(c)
    out.pop("status", None)
    out["apiVersion"] = RESOURCE_API
    out["kind"] = "ResourceClaim"
    out["metadata"] = _meta_to_wire(c.metadata)
    for req in out.get("spec", {}).get("devices", {}).get("requests", []):
        _wrap_cel_selectors(req.get("selectors", []))
    return out


def _claim_status_wire(c: resource.ResourceClaim) -> dict:
    out = _claim_to_wire(c)
    status = resource.to_dict(c.status) if c.status else {}
    alloc = status.get("allocation")
    if alloc and alloc.get("nodeSelector"):
        alloc["nodeSelector"] = _label_map_to_node_selector(
            alloc["nodeSelector"])
    out["status"] = status
    return out


def _class_from_wire(d: dict) -> resource.DeviceClass:
    # upstream shape nests selectors/config under spec, which carries
    # no metadata of its own — decode with a placeholder, then attach
    # the real object metadata
    spec = dict(d.get("spec", d))
    spec.setdefault("metadata", {})
    cls = resource.from_dict(resource.DeviceClass, spec)
    cls.metadata = _meta_from_wire(d.get("metadata", {}))
    return cls


def _class_to_wire(c: resource.DeviceClass) -> dict:
    spec = resource.to_dict(c)
    spec.pop("metadata", None)
    _wrap_cel_selectors(spec.get("selectors", []))
    return {"apiVersion": RESOURCE_API, "kind": "DeviceClass",
            "metadata": _meta_to_wire(c.metadata), "spec": spec}


def _merge_raw(raw: dict, fresh: dict) -> dict:
    """Overlay our modeled fields onto the full object as last read, so
    a sparse dataclass PUT can't wipe unmodeled fields (spec.podCIDR,
    taints, container statuses, …) on a real API server."""
    if not raw:
        return fresh
    out = dict(raw)
    meta = dict(raw.get("metadata", {}))
    fresh_meta = fresh.get("metadata", {})
    meta.update(fresh_meta)
    # labels/annotations are authoritative in the dataclass even when
    # empty (_meta_to_wire omits empty dicts, which would otherwise make
    # removing the last label a silent no-op).
    meta["labels"] = fresh_meta.get("labels", {})
    meta["annotations"] = fresh_meta.get("annotations", {})
    out["metadata"] = meta
    for key, value in fresh.items():
        if key != "metadata":
            out[key] = value
    return out


def _node_from_wire(d: dict) -> Node:
    ready = any(c.get("type") == "Ready" and c.get("status") == "True"
                for c in d.get("status", {}).get("conditions", []))
    return Node(metadata=_meta_from_wire(d.get("metadata", {})),
                ready=ready, raw=d)


def _node_to_wire(n: Node) -> dict:
    return _merge_raw(n.raw, {"apiVersion": "v1", "kind": "Node",
                              "metadata": _meta_to_wire(n.metadata)})


def _deployment_from_wire(d: dict) -> Deployment:
    status = d.get("status", {})
    return Deployment(metadata=_meta_from_wire(d.get("metadata", {})),
                      spec=d.get("spec", {}),
                      ready_replicas=status.get("readyReplicas", 0),
                      replicas=d.get("spec", {}).get("replicas", 1),
                      raw=d)


def _deployment_to_wire(dep: Deployment) -> dict:
    return _merge_raw(dep.raw,
                      {"apiVersion": "apps/v1", "kind": "Deployment",
                       "metadata": _meta_to_wire(dep.metadata),
                       "spec": dep.spec})


def _pod_from_wire(d: dict) -> Pod:
    return Pod(metadata=_meta_from_wire(d.get("metadata", {})),
               spec=d.get("spec", {}),
               node_name=d.get("spec", {}).get("nodeName", ""),
               phase=d.get("status", {}).get("phase", "Pending"),
               raw=d)


def _pod_to_wire(p: Pod) -> dict:
    return _merge_raw(p.raw, {"apiVersion": "v1", "kind": "Pod",
                              "metadata": _meta_to_wire(p.metadata),
                              "spec": p.spec})


_TO_WIRE: dict[str, Callable[[Any], dict]] = {
    "ResourceSlice": _slice_to_wire, "ResourceClaim": _claim_to_wire,
    "DeviceClass": _class_to_wire, "Node": _node_to_wire,
    "Deployment": _deployment_to_wire, "Pod": _pod_to_wire,
}
_FROM_WIRE: dict[str, Callable[[dict], Any]] = {
    "ResourceSlice": _slice_from_wire, "ResourceClaim": _claim_from_wire,
    "DeviceClass": _class_from_wire, "Node": _node_from_wire,
    "Deployment": _deployment_from_wire, "Pod": _pod_from_wire,
}


# --------------------------------------------------------------------------
# auth / transport config
# --------------------------------------------------------------------------

def _load_kubeconfig(path: str) -> tuple[str, dict]:
    """Returns (server, auth) where auth holds token/cert material."""
    import yaml
    cfg = yaml.safe_load(Path(path).read_text())
    ctx_name = cfg.get("current-context", "")
    ctx = next((c["context"] for c in cfg.get("contexts", [])
                if c["name"] == ctx_name),
               cfg.get("contexts", [{}])[0].get("context", {}))
    cluster = next(c["cluster"] for c in cfg["clusters"]
                   if c["name"] == ctx.get("cluster"))
    user = next((u["user"] for u in cfg.get("users", [])
                 if u["name"] == ctx.get("user")), {})
    auth: dict[str, Any] = {}

    # Decoded key material goes into one 0700 dir cleaned up at exit so
    # client keys don't accumulate in /tmp across restarts.
    cred_dir: list[str] = []

    def _pem(d: dict, file_key: str, data_key: str) -> str | None:
        if d.get(file_key):
            return d[file_key]
        if d.get(data_key):
            if not cred_dir:
                cred_dir.append(tempfile.mkdtemp(prefix="tpu-dra-cred-"))
                atexit.register(shutil.rmtree, cred_dir[0],
                                ignore_errors=True)
            path = Path(cred_dir[0]) / f"{data_key}.pem"
            path.touch(mode=0o600)
            path.write_bytes(base64.b64decode(d[data_key]))
            return str(path)
        return None

    auth["ca_file"] = _pem(cluster, "certificate-authority",
                           "certificate-authority-data")
    auth["insecure"] = cluster.get("insecure-skip-tls-verify", False)
    auth["token"] = user.get("token")
    auth["client_cert"] = _pem(user, "client-certificate",
                               "client-certificate-data")
    auth["client_key"] = _pem(user, "client-key", "client-key-data")
    return cluster["server"], auth


def _load_in_cluster() -> tuple[str, dict]:
    import os
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if not host or not (SA_DIR / "token").exists():
        raise RuntimeError(
            "no kubeconfig given and not running in-cluster "
            "(KUBERNETES_SERVICE_HOST unset or service-account token "
            "missing); pass --kubeconfig or --fake-cluster")
    return (f"https://{host}:{port}", {
        # token_file (not a snapshot): bound SA tokens rotate ~hourly
        # and the kubelet rewrites the file; _request re-reads it.
        "token_file": str(SA_DIR / "token"),
        "ca_file": str(SA_DIR / "ca.crt"),
        "namespace": (SA_DIR / "namespace").read_text().strip()
        if (SA_DIR / "namespace").exists() else "default",
    })


# --------------------------------------------------------------------------
# the client
# --------------------------------------------------------------------------

# HTTP statuses worth a client-side retry: throttling and server-side
# blips (client-go's default retriable set for idempotent requests).
RETRYABLE_STATUS = frozenset({429, 500, 502, 503, 504})


def _parse_retry_after(headers) -> float | None:
    """Seconds form only; the HTTP-date form is not worth the parse."""
    raw = headers.get("Retry-After") if headers else None
    if raw is None:
        return None
    try:
        return max(0.0, float(raw))
    except ValueError:
        return None


class RestClusterClient(ClusterClient):
    def __init__(self, server: str, auth: dict, qps: float = 5.0,
                 burst: int = 10, request_timeout: float = 30.0,
                 retry_backoff: Backoff | None = None,
                 conflict_retries: int = 4):
        self.server = server.rstrip("/")
        self.auth = auth
        self.limiter = TokenBucket(qps, burst)
        self.timeout = request_timeout
        # Per-call retry budget for transient failures: bounded both by
        # step count and by a wall-clock deadline (the classified-retry
        # analog of client-go's request retry + flowcontrol wait).
        self.retry_backoff = retry_backoff or Backoff(
            duration_s=0.25, factor=2.0, jitter=0.2, steps=5, cap_s=5.0,
            deadline_s=60.0)
        self.conflict_retries = conflict_retries
        self._stop = threading.Event()
        self._watch_threads: list[threading.Thread] = []

        ctx = ssl.create_default_context()
        if auth.get("ca_file"):
            ctx = ssl.create_default_context(cafile=auth["ca_file"])
        if auth.get("insecure"):
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if auth.get("client_cert"):
            ctx.load_cert_chain(auth["client_cert"],
                                auth.get("client_key"))
        self._ssl_ctx = ctx

    @classmethod
    def from_config(cls, kubeconfig: str | None = None, qps: float = 5.0,
                    burst: int = 10) -> "RestClusterClient":
        if kubeconfig:
            server, auth = _load_kubeconfig(kubeconfig)
        else:
            server, auth = _load_in_cluster()
        return cls(server, auth, qps=qps, burst=burst)

    # -- transport -------------------------------------------------------

    def _url(self, kind: str, namespace: str = "", name: str = "",
             query: str = "") -> str:
        api, plural, namespaced = _KINDS[kind]
        prefix = "/api/" if api == "v1" else "/apis/"
        path = f"{prefix}{api}"
        if namespaced and namespace:
            path += f"/namespaces/{namespace}"
        path += f"/{plural}"
        if name:
            path += f"/{name}"
        if query:
            path += f"?{query}"
        return self.server + path

    def _bearer_token(self) -> str | None:
        """Static token, or the current content of a rotating
        service-account token file (mtime-cached)."""
        token_file = self.auth.get("token_file")
        if not token_file:
            return self.auth.get("token")
        try:
            mtime = Path(token_file).stat().st_mtime
        except OSError:
            return self.auth.get("token")
        cached = getattr(self, "_token_cache", None)
        if cached is None or cached[0] != mtime:
            cached = (mtime, Path(token_file).read_text().strip())
            self._token_cache = cached
        return cached[1]

    def _request(self, method: str, url: str, body: dict | None = None,
                 stream: bool = False, timeout: float | None = None):
        """One API call with classified retries.

        URLError/timeout/429/5xx are retried on idempotent verbs
        (GET/PUT/DELETE); POST retries only failures that provably
        never executed (429, connection refused) so a create cannot
        run twice.  Retry-After is honored when longer than our own
        backoff step, and the whole loop is bounded both by
        ``retry_backoff.steps`` and its wall-clock deadline.  Streamed
        (watch) requests never retry here — the watch loop owns that
        backoff.
        """
        delays = self.retry_backoff.delays()
        deadline_s = self.retry_backoff.deadline_s
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        attempt = 0
        while True:
            try:
                return self._request_once(method, url, body, stream,
                                          timeout)
            except ApiServerError as e:
                if stream or self._stop.is_set() \
                        or not self._retryable(method, e) \
                        or attempt >= len(delays):
                    raise
                delay = delays[attempt]
                attempt += 1
                if e.retry_after_s is not None:
                    delay = max(delay, e.retry_after_s)
                if deadline is not None and \
                        time.monotonic() + delay > deadline:
                    raise
                log.warning("%s %s failed (%s); retry %d/%d in %.2fs",
                            method, url, e, attempt, len(delays), delay)
                time.sleep(delay)

    @staticmethod
    def _retryable(method: str, e: ApiServerError) -> bool:
        if e.status and e.status not in RETRYABLE_STATUS:
            return False
        if method in ("GET", "PUT", "DELETE"):
            return True
        # POST: only failures where the request provably never ran
        return e.status == 429 or getattr(e, "unsent", False)

    def _request_once(self, method: str, url: str, body: dict | None,
                      stream: bool, timeout: float | None):
        # deadline: TokenBucket.acquire self-bounds every sleep to
        # one token interval (utils/flags.py:157-167) and returns
        # immediately when qps<=0 — bounded by rate, not wall time.
        self.limiter.acquire()
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        token = self._bearer_token()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            resp = urllib.request.urlopen(
                req, timeout=timeout or self.timeout, context=self._ssl_ctx)
            if stream:
                return resp
            with resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:500]
            if e.code == 404:
                raise NotFoundError(f"{method} {url}: {detail}") from None
            if e.code == 409:
                raise ConflictError(f"{method} {url}: {detail}") from None
            raise ApiServerError(
                f"{method} {url}: HTTP {e.code}: {detail}", status=e.code,
                retry_after_s=_parse_retry_after(e.headers)) from None
        except (urllib.error.URLError, OSError) as e:
            # connection refused/reset/timeout — the server never
            # answered; mark provably-unsent failures for POST retry
            err = ApiUnavailableError(f"{method} {url}: {e}")
            err.unsent = isinstance(getattr(e, "reason", e),
                                    ConnectionRefusedError)
            raise err from None

    # -- ClusterClient ---------------------------------------------------

    def create(self, obj: Any) -> Any:
        kind = type(obj).__name__
        wire = _TO_WIRE[kind](obj)
        wire["metadata"].pop("resourceVersion", None)
        out = self._request(
            "POST", self._url(kind, obj.metadata.namespace), wire)
        return _FROM_WIRE[kind](out)

    def update(self, obj: Any) -> Any:
        """PUT with bounded conflict re-read-and-retry: on 409, fetch
        the current object, rebase our modeled fields onto its
        resourceVersion (and, for raw-merge kinds, its raw body so
        unmodeled concurrent edits survive), and retry — at most
        ``conflict_retries`` times.  The caller's object is never
        mutated; retries operate on shallow working copies."""
        kind = type(obj).__name__
        url = self._url(kind, obj.metadata.namespace, obj.metadata.name)
        work = obj
        last: ConflictError | None = None
        for _ in range(self.conflict_retries + 1):
            wire = _TO_WIRE[kind](work)
            if not wire["metadata"].get("resourceVersion"):
                current = self._request("GET", url)
                wire["metadata"]["resourceVersion"] = (
                    current["metadata"]["resourceVersion"])
            try:
                out = self._request("PUT", url, wire)
            except ConflictError as e:
                last = e
                fresh = self._request("GET", url)
                work = self._rebase(work, fresh)
                continue
            # Status lives behind a subresource on real API servers; a
            # PUT to the main resource silently drops it, so claim
            # status needs a second write to .../status — including an
            # empty status, or deallocation (allocation = None) would
            # never clear server-side.
            if kind == "ResourceClaim" and work.status is not None:
                out = self._put_claim_status(work, out)
            return _FROM_WIRE[kind](out)
        raise ConflictError(
            f"update {kind} {obj.metadata.namespace}/{obj.metadata.name}: "
            f"still conflicting after {self.conflict_retries} re-reads: "
            f"{last}") from last

    @staticmethod
    def _rebase(obj: Any, fresh: dict) -> Any:
        """Working copy of ``obj`` carried onto ``fresh``'s
        resourceVersion (and raw body, for the merge-on-write kinds)."""
        work = copy.copy(obj)
        work.metadata = copy.copy(obj.metadata)
        rv = fresh.get("metadata", {}).get("resourceVersion", "0")
        work.metadata.resource_version = \
            int(rv) if str(rv).isdigit() else 0
        if hasattr(work, "raw"):
            work.raw = fresh
        return work

    def _put_claim_status(self, obj: Any, main_out: dict) -> dict:
        """The second half of a claim write.  A failure here would
        leave a half-written claim (spec updated, status stale), so
        conflicts re-read the resourceVersion and retry before the
        error surfaces; transient 5xx/429 are already retried one
        level down in ``_request``."""
        url = self._url("ResourceClaim", obj.metadata.namespace,
                        obj.metadata.name) + "/status"
        status_wire = _claim_status_wire(obj)
        rv = main_out["metadata"]["resourceVersion"]
        last: ConflictError | None = None
        for _ in range(self.conflict_retries + 1):
            status_wire["metadata"]["resourceVersion"] = rv
            try:
                return self._request("PUT", url, status_wire)
            except ConflictError as e:
                last = e
                fresh = self._request(
                    "GET", self._url("ResourceClaim",
                                     obj.metadata.namespace,
                                     obj.metadata.name))
                rv = fresh["metadata"]["resourceVersion"]
        raise ApiServerError(
            f"claim {obj.metadata.namespace}/{obj.metadata.name}: main "
            f"resource updated but the status write kept conflicting "
            f"({last}); claim is half-written", status=409) from last

    def apply(self, obj: Any) -> Any:
        try:
            return self.create(obj)
        except ConflictError:
            # rv=0 forces update() to fetch the current version; set it
            # on a working copy — mutating the caller's object would
            # corrupt shared state when an apply is retried
            work = copy.copy(obj)
            work.metadata = copy.copy(obj.metadata)
            work.metadata.resource_version = 0
            return self.update(work)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._request("DELETE", self._url(kind, namespace, name))

    def get(self, kind: str, namespace: str, name: str) -> Any:
        return _FROM_WIRE[kind](
            self._request("GET", self._url(kind, namespace, name)))

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict[str, str] | None = None) -> list[Any]:
        query = ""
        server_side = label_selector and not any(
            "*" in v or "?" in v for v in label_selector.values())
        if server_side:
            query = "labelSelector=" + quote(",".join(
                f"{k}={v}" for k, v in sorted(label_selector.items())))
        out = self._request("GET", self._url(kind, namespace or "",
                                             query=query))
        items = [_FROM_WIRE[kind](i) for i in out.get("items", [])]
        if label_selector and not server_side:  # glob values: client-side
            items = [i for i in items
                     if match_labels(i.metadata.labels, label_selector)]
        if namespace is not None:
            items = [i for i in items
                     if not i.metadata.namespace
                     or i.metadata.namespace == namespace]
        return items

    # -- watch (reflector analog) ---------------------------------------

    def watch(self, kind: str, handler: WatchHandler) -> Callable[[], None]:
        stop = threading.Event()
        t = threading.Thread(target=self._watch_loop,
                             args=(kind, handler, stop),
                             name=f"watch-{kind}", daemon=True)
        t.start()
        self._watch_threads.append(t)

        def unsubscribe():
            stop.set()

        return unsubscribe

    @staticmethod
    def _same_version(a: Any, b: Any) -> bool:
        """Unchanged across a relist = same resourceVersion (or, when a
        server omits it, equal objects)."""
        rv_a = getattr(a.metadata, "resource_version", 0)
        rv_b = getattr(b.metadata, "resource_version", 0)
        if rv_a or rv_b:
            return rv_a == rv_b
        return a == b

    def _watch_loop(self, kind: str, handler: WatchHandler,
                    stop: threading.Event) -> None:
        backoff = 1.0
        # (namespace, name) -> object seen, for synthesizing DELETED
        # events across relists (client-go reflector replace semantics:
        # objects that vanished during a watch gap must be reported).
        known: dict[tuple[str, str], Any] = {}
        while not (stop.is_set() or self._stop.is_set()):
            try:
                out = self._request("GET", self._url(kind))
                rv = out.get("metadata", {}).get("resourceVersion", "0")
                seen: dict[tuple[str, str], Any] = {}
                for item in out.get("items", []):
                    obj = _FROM_WIRE[kind](item)
                    key = (obj.metadata.namespace, obj.metadata.name)
                    seen[key] = obj
                    # Diff against the previous window instead of
                    # re-emitting ADDED for the whole world on every
                    # 300s relist: new objects are ADDED, changed ones
                    # MODIFIED, unchanged ones silent (client-go
                    # reflector replace semantics).
                    prev = known.get(key)
                    if prev is None:
                        handler("ADDED", obj)
                    elif not self._same_version(prev, obj):
                        handler("MODIFIED", obj)
                for key, obj in known.items():
                    if key not in seen:
                        handler("DELETED", obj)
                known = seen
                # timeoutSeconds makes the server end quiet watch
                # windows gracefully (EOF) before our 330s client read
                # timeout — otherwise an idle stream always surfaces as
                # socket.timeout and takes the failure path below.
                resp = self._request(
                    "GET",
                    self._url(kind,
                              query=f"watch=true&resourceVersion={rv}"
                                    "&allowWatchBookmarks=false"
                                    "&timeoutSeconds=300"),
                    stream=True, timeout=330)
                delivered = False
                stream_started = time.monotonic()
                with resp:
                    for line in resp:
                        if stop.is_set() or self._stop.is_set():
                            return
                        if not line.strip():
                            continue
                        ev = json.loads(line)
                        etype = ev.get("type", "")
                        if etype in ("ADDED", "MODIFIED", "DELETED"):
                            # A delivered event is the only success
                            # signal that resets the backoff: resetting
                            # on relist or stream-open would hot-loop
                            # when the watch persistently fails or
                            # immediately returns ERROR (410 Gone).
                            delivered = True
                            backoff = 1.0
                            obj = _FROM_WIRE[kind](ev["object"])
                            key = (obj.metadata.namespace,
                                   obj.metadata.name)
                            if etype == "DELETED":
                                known.pop(key, None)
                            else:
                                known[key] = obj
                            handler(etype, obj)
                        elif etype == "ERROR":
                            raise RuntimeError(
                                f"watch ERROR event: {ev.get('object')}")
                if delivered or \
                        time.monotonic() - stream_started >= 30.0:
                    # A long-lived stream is healthy even when idle (a
                    # quiet cluster times out watch windows with zero
                    # events); only an instant EOF indicates a broken
                    # watch endpoint.
                    backoff = 1.0
                else:
                    raise RuntimeError(
                        "watch stream ended almost immediately with no "
                        "events")
            except Exception as e:
                if stop.is_set() or self._stop.is_set():
                    return
                log.warning("watch %s failed (%s); retrying in %.0fs",
                            kind, e, backoff)
                stop.wait(backoff)
                backoff = min(backoff * 2, 30.0)

    def close(self) -> None:
        self._stop.set()
