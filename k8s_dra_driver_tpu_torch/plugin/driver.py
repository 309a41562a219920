"""The kubelet-plugin driver: gRPC servers + resource publication.

The port's copy of ``k8s_dra_driver_tpu/plugin/driver.py``: the same
sockets, registration answer, publication retry and in-band per-claim
errors.  The analog of the reference's driver + vendored kubeletplugin helper
(reference cmd/nvidia-dra-plugin/driver.go:31-152 and
vendor/.../kubeletplugin/draplugin.go:263-421): two gRPC servers on unix
sockets — the DRA NodeServer kubelet calls for prepare/unprepare, and
the registration service for the kubelet plugin-discovery handshake —
plus per-node ResourceSlice publication.

Prepare/unprepare are serialized under one mutex exactly like the
reference (driver.go:117, a deliberate simplicity-over-parallelism
choice on the pod-startup path), and each claim is re-fetched from the
API surface and UID-checked before preparing (driver.go:120-127).
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent import futures
from pathlib import Path

import grpc

from ..api import resource
from ..cluster import ClusterClient, NotFoundError
from ..utils.backoff import Backoff
from ..utils.metrics import DriverMetrics
from . import publisher as publisher_mod
from .device_state import DRIVER_NAME, DeviceState
from ..proto import (dra_pb2, registration_pb2, DRAPluginServicer,
                     RegistrationServicer, add_dra_servicer,
                     add_registration_servicer)

log = logging.getLogger(__name__)

PLUGIN_SOCKET_NAME = "plugin.sock"
REGISTRAR_SOCKET_NAME = "tpu.google.com-reg.sock"
SUPPORTED_VERSIONS = ("v1alpha3", "v1alpha4")


class _Registrar(RegistrationServicer):
    def __init__(self, driver_name: str, endpoint: str):
        self.driver_name = driver_name
        self.endpoint = endpoint
        self.registered = threading.Event()
        self.registration_error = ""

    def GetInfo(self, request, context):
        return registration_pb2.PluginInfo(
            type="DRAPlugin", name=self.driver_name, endpoint=self.endpoint,
            supported_versions=list(SUPPORTED_VERSIONS))

    def NotifyRegistrationStatus(self, request, context):
        if request.plugin_registered:
            self.registered.set()
        else:
            self.registration_error = request.error
        return registration_pb2.RegistrationStatusResponse()


# Boot-publication retry: ~13 attempts over roughly two minutes of
# capped exponential backoff; after that the periodic health monitor
# owns the republish (its _publish_pending analog), so the bounded
# budget here never turns into an abandoned node.
PUBLISH_BACKOFF = Backoff(duration_s=0.5, factor=2.0, jitter=0.2,
                          steps=13, cap_s=15.0, deadline_s=120.0)


class Driver(DRAPluginServicer):
    def __init__(self, state: DeviceState, client: ClusterClient,
                 plugin_dir: str, metrics: DriverMetrics | None = None,
                 registrar_dir: str | None = None,
                 publish_backoff: Backoff | None = None):
        self.state = state
        self.client = client
        self.plugin_dir = Path(plugin_dir)
        self.plugin_dir.mkdir(parents=True, exist_ok=True)
        self.metrics = metrics or DriverMetrics()
        self._lock = threading.Lock()   # serializes all prepares on a node
        self._publish_lock = threading.Lock()
        self._publish_backoff = publish_backoff or PUBLISH_BACKOFF
        self._publish_stop = threading.Event()
        self._publish_thread: threading.Thread | None = None
        # True while node label + ResourceSlices are not known to be
        # current on the API server (the health monitor republishes on
        # its next tick when the bounded boot retry gives up).
        self.publish_pending = False
        self._servers: list[grpc.Server] = []
        self.plugin_socket = self.plugin_dir / PLUGIN_SOCKET_NAME
        # Real kubelets discover plugins via a separate registry dir
        # (/var/lib/kubelet/plugins_registry); default next to the plugin
        # socket for hermetic runs.
        self.registrar_socket = (Path(registrar_dir or plugin_dir)
                                 / REGISTRAR_SOCKET_NAME)
        self.registrar = _Registrar(DRIVER_NAME, str(self.plugin_socket))

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        plugin_server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        add_dra_servicer(self, plugin_server)
        plugin_server.add_insecure_port(f"unix://{self.plugin_socket}")
        plugin_server.start()

        reg_server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        add_registration_servicer(self.registrar, reg_server)
        reg_server.add_insecure_port(f"unix://{self.registrar_socket}")
        reg_server.start()

        self._servers = [plugin_server, reg_server]
        # The gRPC servers are up — kubelet can already call prepare
        # (prepared claims re-fetch through the same client and fail
        # in-band).  Publication must not take the whole plugin down
        # with an apiserver that is merely unreachable at boot.
        try:
            self._ensure_node_label()
            self.publish_resources()
        except Exception as e:
            log.warning("apiserver unreachable at boot (%s); queuing "
                        "resource publication behind backoff", e)
            self._queue_publish()

    def shutdown(self, grace: float = 1.0) -> None:
        self._publish_stop.set()
        for s in self._servers:
            s.stop(grace)
        self._servers = []
        if self._publish_thread is not None:
            self._publish_thread.join(timeout=5)
            self._publish_thread = None

    def _ensure_node_label(self) -> None:
        """Self-label this Node with its slice identity so the controller
        can aggregate the gang (the node-labeling the reference leaves to
        out-of-band tooling for IMEX domains)."""
        from .. import SLICE_LABEL
        sl = self.state.topology.slice
        if sl is None:
            return
        try:
            node = self.client.get("Node", "", self.state.config.node_name)
        except NotFoundError:
            return
        value = f"{sl.slice_id}.{sl.topology}"
        if node.metadata.labels.get(SLICE_LABEL) != value:
            node.metadata.labels[SLICE_LABEL] = value
            self.client.update(node)

    # -- publication ------------------------------------------------------

    def publish_resources(self) -> None:
        """Reconcile this node's ResourceSlices; raises on failure (the
        health monitor's _publish_pending pattern relies on that)."""
        with self._publish_lock:
            self.publish_pending = True
            devices = [dev.to_device()
                       for _, dev in sorted(self.state.allocatable.items())]
            pool = publisher_mod.PoolSpec(
                name=self.state.config.node_name, devices=devices,
                node_name=self.state.config.node_name)
            pub = publisher_mod.ResourceSlicePublisher(
                self.client, DRIVER_NAME,
                owner_id=f"node-{self.state.config.node_name}",
                metrics=self.metrics)
            pub.publish([pool])
            self.publish_pending = False

    def _queue_publish(self) -> None:
        """Retry node label + publication on a daemon thread with a
        bounded backoff (steps AND deadline).  On exhaustion the
        publish_pending flag stays set so the periodic health monitor
        keeps reconciling — bounded retry, unbounded ownership."""
        if self._publish_thread is not None and \
                self._publish_thread.is_alive():
            return
        self.publish_pending = True

        def attempt() -> bool:
            if self._publish_stop.is_set():
                return True              # shutting down: stop retrying
            try:
                self._ensure_node_label()
                self.publish_resources()
                log.info("queued resource publication succeeded")
                return True
            except Exception as e:
                log.warning("queued resource publication failed (%s); "
                            "backing off", e)
                return False

        def run() -> None:
            done = self._publish_backoff.poll(
                attempt, sleep=lambda s: self._publish_stop.wait(s))
            if not done and not self._publish_stop.is_set():
                log.error("resource publication still failing after "
                          "bounded retries; health monitor will keep "
                          "trying on its interval")

        self._publish_thread = threading.Thread(
            target=run, name="tpu-publish-retry", daemon=True)
        self._publish_thread.start()

    # -- DRA service ------------------------------------------------------

    def NodePrepareResources(self, request, context):
        resp = dra_pb2.NodePrepareResourcesResponse()
        for claim_ref in request.claims:
            resp.claims[claim_ref.uid].CopyFrom(
                self._node_prepare_resource(claim_ref))
        return resp

    def _node_prepare_resource(self, claim_ref):
        start = time.monotonic()
        with self._lock:
            try:
                claim = self._fetch_claim(claim_ref)
                prepared = self.state.prepare(claim)
            except Exception as e:  # error travels in-band per claim
                self._observe("prepare", start, "error")
                return dra_pb2.NodePrepareResourceResponse(
                    error=f"failed to prepare claim {claim_ref.uid}: {e}")
        out = dra_pb2.NodePrepareResourceResponse()
        for dev in prepared.devices:
            out.devices.append(dra_pb2.Device(
                request_names=[dev.request], pool_name=dev.pool,
                device_name=dev.device_name,
                cdi_device_ids=dev.cdi_device_ids))
        self._observe("prepare", start, "ok")
        self.metrics.prepared_claims.set(len(self.state.prepared))
        return out

    def NodeUnprepareResources(self, request, context):
        resp = dra_pb2.NodeUnprepareResourcesResponse()
        for claim_ref in request.claims:
            start = time.monotonic()
            with self._lock:
                try:
                    self.state.unprepare(claim_ref.uid)
                    resp.claims[claim_ref.uid].CopyFrom(
                        dra_pb2.NodeUnprepareResourceResponse())
                    self._observe("unprepare", start, "ok")
                except Exception as e:
                    self._observe("unprepare", start, "error")
                    resp.claims[claim_ref.uid].CopyFrom(
                        dra_pb2.NodeUnprepareResourceResponse(
                            error=f"failed to unprepare claim "
                                  f"{claim_ref.uid}: {e}"))
            self.metrics.prepared_claims.set(len(self.state.prepared))
        return resp

    def _fetch_claim(self, claim_ref) -> resource.ResourceClaim:
        try:
            claim = self.client.get("ResourceClaim", claim_ref.namespace,
                                    claim_ref.name)
        except NotFoundError:
            raise RuntimeError(
                f"claim {claim_ref.namespace}/{claim_ref.name} not found")
        if claim.metadata.uid != claim_ref.uid:
            raise RuntimeError(
                f"claim {claim_ref.namespace}/{claim_ref.name} UID mismatch: "
                f"have {claim.metadata.uid}, kubelet sent {claim_ref.uid}")
        return claim

    def _observe(self, op: str, start: float, outcome: str) -> None:
        hist = (self.metrics.prepare_seconds if op == "prepare"
                else self.metrics.unprepare_seconds)
        hist.labels(outcome=outcome).observe(time.monotonic() - start)
