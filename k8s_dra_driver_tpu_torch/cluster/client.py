"""Cluster client interface + in-memory fake implementation.

The port's copy of ``k8s_dra_driver_tpu/cluster/client.py``: the
``ClusterClient`` surface, its error types, the ``EVENT_*`` watch
names, ``match_labels`` and ``FakeCluster``, a thread-safe in-memory
object store with list/watch semantics faithful enough for
informer-style consumers: watchers receive ADDED events for
pre-existing objects, then live ADDED/MODIFIED/DELETED events in order.
``cluster/faults.py``'s ``FaultyClusterClient`` wraps any of them.

A real-cluster implementation plugs in behind the same interface; none
is imported here, so the package works without a cluster.
"""

from __future__ import annotations

import fnmatch
import threading
from typing import Any, Callable

EVENT_ADDED = "ADDED"
EVENT_MODIFIED = "MODIFIED"
EVENT_DELETED = "DELETED"

WatchHandler = Callable[[str, Any], None]


class NotFoundError(KeyError):
    pass


class ConflictError(RuntimeError):
    pass


class ApiServerError(RuntimeError):
    """A server-side or transport failure that is not NotFound/Conflict.

    Raised by the REST client once its classified-retry budget is
    exhausted, and by the fault-injection layer for scripted 429/5xx
    responses.  ``status`` is the HTTP status (0 for connection-level
    failures), ``retry_after_s`` carries a parsed Retry-After when the
    server sent one.
    """

    def __init__(self, message: str, status: int = 500,
                 retry_after_s: float | None = None):
        super().__init__(message)
        self.status = status
        self.retry_after_s = retry_after_s


class ApiUnavailableError(ApiServerError):
    """Connection-level failure: refused, reset, or timed out before a
    response arrived (URLError/timeout analog)."""

    def __init__(self, message: str,
                 retry_after_s: float | None = None):
        super().__init__(message, status=0, retry_after_s=retry_after_s)


def _kind_of(obj: Any) -> str:
    return type(obj).__name__


def _key(obj: Any) -> tuple[str, str]:
    return (obj.metadata.namespace, obj.metadata.name)


def match_labels(labels: dict[str, str],
                 selector: dict[str, str] | None) -> bool:
    """Label-selector match; values support ``*`` globs for test
    convenience (upstream equality selectors are a subset)."""
    if not selector:
        return True
    for k, want in selector.items():
        have = labels.get(k)
        if have is None:
            return False
        if not fnmatch.fnmatchcase(have, want):
            return False
    return True


class ClusterClient:
    """Interface every cluster backend implements."""

    def create(self, obj: Any) -> Any: raise NotImplementedError
    def update(self, obj: Any) -> Any: raise NotImplementedError
    def delete(self, kind: str, namespace: str, name: str) -> None:
        raise NotImplementedError
    def get(self, kind: str, namespace: str, name: str) -> Any:
        raise NotImplementedError
    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict[str, str] | None = None) -> list[Any]:
        raise NotImplementedError
    def watch(self, kind: str, handler: WatchHandler) -> Callable[[], None]:
        """Register a watcher; returns an unsubscribe function."""
        raise NotImplementedError


class FakeCluster(ClusterClient):
    def __init__(self):
        self._lock = threading.Lock()
        self._objects: dict[str, dict[tuple[str, str], Any]] = {}
        self._watchers: dict[str, list[WatchHandler]] = {}
        self._rv = 0

    # -- helpers ---------------------------------------------------------

    def _emit(self, kind: str, event: str, obj: Any,
              handlers: list[WatchHandler]) -> None:
        for h in handlers:
            h(event, obj)

    def _bump(self, obj: Any) -> None:
        self._rv += 1
        obj.metadata.resource_version = self._rv

    # -- ClusterClient ---------------------------------------------------

    def create(self, obj: Any) -> Any:
        kind = _kind_of(obj)
        with self._lock:
            store = self._objects.setdefault(kind, {})
            key = _key(obj)
            if key in store:
                raise ConflictError(f"{kind} {key} already exists")
            self._bump(obj)
            store[key] = obj
            handlers = list(self._watchers.get(kind, []))
        self._emit(kind, EVENT_ADDED, obj, handlers)
        return obj

    def update(self, obj: Any) -> Any:
        kind = _kind_of(obj)
        with self._lock:
            store = self._objects.setdefault(kind, {})
            key = _key(obj)
            if key not in store:
                raise NotFoundError(f"{kind} {key} not found")
            self._bump(obj)
            store[key] = obj
            handlers = list(self._watchers.get(kind, []))
        self._emit(kind, EVENT_MODIFIED, obj, handlers)
        return obj

    def apply(self, obj: Any) -> Any:
        """Create-or-update convenience (server-side-apply analog)."""
        try:
            return self.create(obj)
        except ConflictError:
            return self.update(obj)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            store = self._objects.get(kind, {})
            obj = store.pop((namespace, name), None)
            handlers = list(self._watchers.get(kind, []))
        if obj is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        self._emit(kind, EVENT_DELETED, obj, handlers)

    def get(self, kind: str, namespace: str, name: str) -> Any:
        with self._lock:
            obj = self._objects.get(kind, {}).get((namespace, name))
        if obj is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        return obj

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict[str, str] | None = None) -> list[Any]:
        with self._lock:
            objs = list(self._objects.get(kind, {}).values())
        out = []
        for o in objs:
            if namespace is not None and o.metadata.namespace != namespace:
                continue
            if not match_labels(o.metadata.labels, label_selector):
                continue
            out.append(o)
        return sorted(out, key=lambda o: _key(o))

    def watch(self, kind: str, handler: WatchHandler) -> Callable[[], None]:
        with self._lock:
            existing = list(self._objects.get(kind, {}).values())
            self._watchers.setdefault(kind, []).append(handler)
        for obj in sorted(existing, key=lambda o: _key(o)):
            handler(EVENT_ADDED, obj)

        def unsubscribe() -> None:
            with self._lock:
                try:
                    self._watchers.get(kind, []).remove(handler)
                except ValueError:
                    pass
        return unsubscribe


__all__ = ["ApiServerError", "ApiUnavailableError", "ClusterClient",
           "ConflictError", "EVENT_ADDED", "EVENT_DELETED",
           "EVENT_MODIFIED", "FakeCluster", "NotFoundError",
           "WatchHandler", "match_labels"]
