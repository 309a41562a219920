"""Optional HTTP observability endpoint.

The port's copy of ``k8s_dra_driver_tpu/utils/httpendpoint.py``:
metrics plus a profiling surface on one listener.

- ``/metrics``            — text exposition of the registries
  (``render_all`` over ``metrics`` and ``extra_metrics``)
- ``/healthz``            — liveness
- ``/debugz``             — a JSON dump (mounted when a
  ``debug_source`` is given)
- ``/debug/pprof/``       — index
- ``/debug/pprof/goroutine`` (and ``/debug/stacks``) — live stack dump
  of every Python thread (the goroutine-profile analog)
- ``/debug/pprof/profile?seconds=N`` — statistical whole-process
  profile: samples every thread's stack ~100×/s for N seconds and
  returns aggregated stack counts (cProfile only hooks the calling
  thread, which would profile the handler's own sleep)
"""

from __future__ import annotations

import collections
import json
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .metrics import render_all


def _thread_stacks() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"thread {names.get(ident, '?')} ({ident}):")
        out.extend(l.rstrip() for l in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def _cpu_profile(seconds: float, hz: float = 100.0,
                 own_ident: int | None = None) -> str:
    """Sampled stack profile across all threads (py-spy style)."""
    counts: collections.Counter[tuple] = collections.Counter()
    samples = 0
    deadline = time.monotonic() + seconds
    interval = 1.0 / hz
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == own_ident:
                continue
            stack = tuple(
                f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:"
                f"{f.f_lineno}:{f.f_code.co_name}"
                for f in _frame_chain(frame))
            counts[stack] += 1
        samples += 1
        time.sleep(interval)
    out = [f"# {samples} samples at {hz:g} Hz over {seconds:g}s",
           "# count  stack (innermost last)"]
    for stack, n in counts.most_common(50):
        out.append(f"{n:7d}  {' < '.join(reversed(stack[-12:]))}")
    return "\n".join(out) + "\n"


def _frame_chain(frame):
    chain = []
    while frame is not None:
        chain.append(frame)
        frame = frame.f_back
    return list(reversed(chain))


class HTTPEndpoint:
    """``metrics`` is any object with ``render() -> bytes``
    (``DriverMetrics`` in the plugin binary); ``extra_metrics`` appends further
    registries to the same ``/metrics`` exposition — how a process
    that runs the fleet stack (gateway, reconciler, ``MemWatch``)
    exports their state on the one scrape endpoint (utils/metrics.py
    ``render_all``)."""

    def __init__(self, address: str, metrics,
                 pprof_prefix: str = "/debug/pprof",
                 extra_metrics=(),
                 debug_source=None):
        host, _, port = address.rpartition(":")
        self.metrics = metrics
        self.extra_metrics = tuple(extra_metrics)
        #: zero-arg callable returning a JSON-serializable dict —
        #: mounted on ``/debugz``; None = 404
        self.debug_source = debug_source
        self._profile_lock = threading.Lock()
        prefix = pprof_prefix.rstrip("/")
        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet access log
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                path = url.path.rstrip("/") or "/"
                if path == "/metrics":
                    self._send(render_all(endpoint.metrics,
                                          *endpoint.extra_metrics),
                               "text/plain; version=0.0.4")
                elif path == "/healthz":
                    self._send(b"ok", "text/plain")
                elif path == "/debugz":
                    if endpoint.debug_source is None:
                        return self._send(b"no debug source",
                                          "text/plain", 404)
                    try:
                        body = json.dumps(endpoint.debug_source(),
                                          sort_keys=True).encode()
                    except Exception as e:
                        return self._send(
                            f"debug dump failed: {e}".encode(),
                            "text/plain", 500)
                    self._send(body, "application/json")
                elif path in (f"{prefix}/goroutine", "/debug/stacks"):
                    self._send(_thread_stacks().encode(), "text/plain")
                elif path == f"{prefix}/profile":
                    try:
                        secs = float(parse_qs(url.query).get(
                            "seconds", ["1"])[0])
                    except ValueError:
                        return self._send(b"bad seconds", "text/plain",
                                          400)
                    secs = min(max(secs, 0.1), 60.0)
                    # one profiler at a time: each request occupies a
                    # handler thread sampling at 100 Hz for up to 60s,
                    # so concurrent requests would pile up unboundedly
                    if not endpoint._profile_lock.acquire(blocking=False):
                        return self._send(b"profile already running",
                                          "text/plain", 429)
                    try:
                        body = _cpu_profile(
                            secs, own_ident=threading.get_ident())
                    finally:
                        endpoint._profile_lock.release()
                    self._send(body.encode(), "text/plain")
                elif path == prefix:
                    self._send(b"goroutine\nprofile\n", "text/plain")
                else:
                    self._send(b"not found", "text/plain", 404)

        # Empty host binds loopback: the debug surface (60s stack
        # sampling per /profile hit) must be opted into a wide bind by
        # an explicit address — the chart passes "0.0.0.0:8080" so
        # Prometheus can scrape pods, a standalone run stays local.
        self.server = ThreadingHTTPServer((host or "127.0.0.1", int(port)),
                                          Handler)
        self.address = (f"{self.server.server_address[0]}:"
                        f"{self.server.server_address[1]}")
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.server.serve_forever, name="http-endpoint",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
