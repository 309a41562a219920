"""The cluster-level controller binary (the port of
``k8s_dra_driver_tpu/cmd/controller.py``, the reference's
``tpu-dra-controller``), run as ``python -m
k8s_dra_driver_tpu_torch.cmd.controller``.  It imports no torch.

The analog of the reference's controller entrypoint (reference
cmd/nvidia-dra-controller/main.go:66-241): flags with env mirrors, an
optional HTTP endpoint carrying Prometheus metrics and a profiling
surface (SetupHTTPEndpoint analog, main.go:194-241), and the slice-gang
manager — started only when the ``podslice`` device class is enabled,
mirroring the imex gating (main.go:171-176).  The owning Pod is looked
up so published ResourceSlices carry an owner reference and get garbage
collected with the controller (imex.go:81-92).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from ..api import resource
from ..utils import info
from ..utils.flags import KubeClientConfig, LoggingConfig, env_default
from ..utils.metrics import DriverMetrics

log = logging.getLogger("tpu-dra-controller")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m k8s_dra_driver_tpu_torch.cmd.controller",
        description="TPU DRA slice-gang controller (tpu.google.com)")
    p.add_argument("--version", action="version",
                   version=info.get_version_string())
    p.add_argument("--device-classes",
                   default=env_default("DEVICE_CLASSES",
                                       "chip,core,slice,podslice"),
                   help="enabled device classes; the gang manager only "
                        "starts when 'podslice' is present "
                        "[env DEVICE_CLASSES]")
    p.add_argument("--namespace",
                   default=env_default("NAMESPACE", "tpu-dra-driver"),
                   help="namespace this controller runs in "
                        "[env NAMESPACE]")
    p.add_argument("--pod-name",
                   default=env_default("POD_NAME", ""),
                   help="name of the Pod running this controller, for "
                        "ResourceSlice owner references [env POD_NAME]")
    p.add_argument("--http-endpoint",
                   default=env_default("HTTP_ENDPOINT", ""),
                   help="host:port for /metrics + /healthz + /debug/pprof; "
                        "empty disables [env HTTP_ENDPOINT]")
    p.add_argument("--channels-per-slice", type=int,
                   default=env_default("CHANNELS_PER_SLICE", 128, int),
                   help="rendezvous channels carved per pod slice "
                        "[env CHANNELS_PER_SLICE] (default 128)")
    p.add_argument("--retry-delay", type=float,
                   default=env_default("RETRY_DELAY_SECONDS", 60.0, float),
                   help="requeue delay after transient publish errors "
                        "[env RETRY_DELAY_SECONDS] (default 60)")
    KubeClientConfig.add_flags(p)
    LoggingConfig.add_flags(p)
    return p


def _owner_reference(client, namespace: str,
                     pod_name: str) -> resource.OwnerReference | None:
    """Own published slices via our Pod so they are garbage-collected
    with the controller (imex.go:81-92)."""
    if not pod_name:
        return None
    try:
        pod = client.get("Pod", namespace, pod_name)
    except Exception:
        log.warning("could not fetch own pod %s/%s; publishing without "
                    "owner reference", namespace, pod_name)
        return None
    return resource.OwnerReference(api_version="v1", kind="Pod",
                                   name=pod.metadata.name,
                                   uid=pod.metadata.uid)


def run(args: argparse.Namespace, client=None,
        ready_event: threading.Event | None = None,
        stop_event: threading.Event | None = None) -> int:
    from ..controller import SliceGangController

    LoggingConfig.apply(args)
    log.info("tpu-dra-controller starting (version %s)",
             info.get_version_string())
    client = client or KubeClientConfig.build_client(args)
    classes = {c.strip() for c in args.device_classes.split(",")}
    metrics = DriverMetrics()

    endpoint = None
    if args.http_endpoint:
        from ..utils.httpendpoint import HTTPEndpoint
        endpoint = HTTPEndpoint(args.http_endpoint, metrics)
        endpoint.start()
        log.info("serving metrics + pprof on %s", endpoint.address)

    controller = None
    if "podslice" in classes:
        controller = SliceGangController(
            client,
            owner=_owner_reference(client, args.namespace, args.pod_name),
            metrics=metrics,
            channels_per_slice=args.channels_per_slice,
            retry_delay_s=args.retry_delay)
        controller.start()
        log.info("slice-gang manager started")
    else:
        log.info("'podslice' not in --device-classes; gang manager "
                 "disabled")

    stop = stop_event or threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass
    if ready_event is not None:
        ready_event.set()
    try:
        # deadline: process-lifetime wait; SIGTERM/SIGINT set the
        # event (the reference blocks the same way, main.go run()).
        stop.wait()
    finally:
        log.info("shutting down")
        if controller:
            controller.stop()
        if endpoint:
            endpoint.stop()
    return 0


def main(argv: list[str] | None = None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
