"""Shared CLI flag groups with environment-variable mirrors (the port's
copy of ``k8s_dra_driver_tpu/utils/flags.py``).

The analog of the reference's pkg/flags (KubeClientConfig:
kubeconfig/QPS/burst → clientsets, reference pkg/flags/kubeclient.go:
30-106; LoggingConfig: format/verbosity bridging, logging.go:33-88) and
of its urfave/cli convention that every flag has an env-var mirror
(reference cmd/nvidia-dra-plugin/main.go:73-123).  ``env_default``
implements the mirror: the flag's default is taken from the named
environment variable when set, while an explicit CLI value always wins.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time


def env_default(name: str, fallback=None, cast=None):
    """Default-from-environment for argparse (the EnvVars mirror)."""
    raw = os.environ.get(name)
    if raw is None:
        return fallback
    return cast(raw) if cast else raw


def env_flag(name: str, default: bool = False) -> bool:
    """One boolean-env convention for the whole tree: unset ->
    ``default``; ``""``, ``"0"``, ``"false"`` (any case) -> False;
    anything else -> True (the FAKE_CLUSTER argparse default), so
    ``=0`` and ``=false`` mean "off" everywhere."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() not in ("", "0", "false")


# --------------------------------------------------------------------------
# Kube client flags (KubeClientConfig analog)
# --------------------------------------------------------------------------

class KubeClientConfig:
    """Builds a ClusterClient from flags.

    ``--kubeconfig`` / in-cluster service account selects the REST
    backend; ``--fake-cluster`` selects the in-memory backend for
    hermetic/demo runs (a fake backend, which the reference lacks).  QPS/burst mirror the reference's
    client-go rate limits (kubeclient.go:49-64).
    """

    @staticmethod
    def add_flags(p: argparse.ArgumentParser) -> None:
        g = p.add_argument_group("kube client")
        g.add_argument("--kubeconfig",
                       default=env_default("KUBECONFIG"),
                       help="absolute path to a kubeconfig file "
                            "[env KUBECONFIG]")
        g.add_argument("--kube-api-qps", type=float,
                       default=env_default("KUBE_API_QPS", 5.0, float),
                       help="client-side QPS limit toward the API server "
                            "[env KUBE_API_QPS] (default 5)")
        g.add_argument("--kube-api-burst", type=int,
                       default=env_default("KUBE_API_BURST", 10, int),
                       help="client-side burst toward the API server "
                            "[env KUBE_API_BURST] (default 10)")
        g.add_argument("--fake-cluster", action="store_true",
                       default=env_flag("FAKE_CLUSTER"),
                       help="use the in-memory fake cluster backend "
                            "(hermetic demos/tests) [env FAKE_CLUSTER]")

    @staticmethod
    def build_client(args: argparse.Namespace):
        if args.fake_cluster:
            from ..cluster import FakeCluster
            return FakeCluster()
        from ..cluster.rest import RestClusterClient
        return RestClusterClient.from_config(
            kubeconfig=args.kubeconfig,
            qps=args.kube_api_qps, burst=args.kube_api_burst)


# --------------------------------------------------------------------------
# Logging flags (LoggingConfig analog)
# --------------------------------------------------------------------------

class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry)


class LoggingConfig:
    """Text/JSON logging with a klog-style -v verbosity knob
    (reference pkg/flags/logging.go:33-88)."""

    @staticmethod
    def add_flags(p: argparse.ArgumentParser) -> None:
        g = p.add_argument_group("logging")
        g.add_argument("-v", "--v", dest="log_verbosity", type=int,
                       default=env_default("LOG_VERBOSITY", 0, int),
                       help="log verbosity: 0=info, >=4 debug "
                            "[env LOG_VERBOSITY]")
        g.add_argument("--log-format", choices=("text", "json"),
                       default=env_default("LOG_FORMAT", "text"),
                       help="log output format [env LOG_FORMAT]")

    @staticmethod
    def apply(args: argparse.Namespace) -> None:
        level = logging.DEBUG if args.log_verbosity >= 4 else logging.INFO
        handler = logging.StreamHandler(sys.stderr)
        if args.log_format == "json":
            handler.setFormatter(_JsonFormatter())
        else:
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname).1s %(name)s: %(message)s",
                datefmt="%H:%M:%S"))
        root = logging.getLogger()
        root.handlers[:] = [handler]
        root.setLevel(level)


# --------------------------------------------------------------------------
# Rate limiter shared by REST clients (client-go flowcontrol analog)
# --------------------------------------------------------------------------

class TokenBucket:
    """QPS/burst token bucket (client-go's default rate limiter that the
    reference configures at kubeclient.go:49-64)."""

    def __init__(self, qps: float = 5.0, burst: int = 10):
        self.qps = qps
        # burst < 1 would pin the bucket at zero tokens and spin
        # forever; clamp to 1 so the qps limit still applies
        # (client-go rejects burst<1 outright).
        self.burst = max(burst, 1) if qps > 0 else burst
        self._tokens = float(self.burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self) -> None:
        if self.qps <= 0:       # k8s convention: non-positive = unlimited
            return
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.qps)
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.qps
            time.sleep(wait)
