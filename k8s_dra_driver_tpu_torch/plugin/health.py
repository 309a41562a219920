"""Chip health monitor: failed hardware leaves the scheduler's view.

The port's copy of ``k8s_dra_driver_tpu/plugin/health.py``.  The
reference has no health surface at all: a GPU that falls off the bus
stays published in its ResourceSlices until an operator notices.  The
discovery backend's ``health()`` view reports failed chips (on a TPU
host a missing device node or an accel-class sysfs health attribute;
on an NVIDIA host a missing ``/dev/nvidia<minor>`` or, where the
driver's procfs is seen, a vanished PCI device), and on any change this
monitor:

- filters the published allocatable set through
  ``DeviceState.apply_health`` (a failed chip takes its core
  partitions and every slice containing it with it),
- republishes the node's ResourceSlices, so upcoming scheduling
  decisions cannot land on broken hardware,
- updates the ``tpu_dra_unhealthy_chips`` gauge and logs the
  transition with per-chip reasons.

Prepared claims are left alone: kubelet owns their lifecycle, and an
in-flight workload on a failed chip surfaces its own errors; what the
driver must guarantee is that *new* claims stop landing there.
"""

from __future__ import annotations

import logging
import threading

log = logging.getLogger(__name__)


class HealthMonitor:
    """Polls ``backend.health()`` and pushes changes into the driver.

    ``check_once`` is the testable unit; ``start`` runs it on a
    daemon-thread interval the way the kubelet plugin binary does
    (cmd/plugin.py ``--health-interval``).
    """

    def __init__(self, driver, backend, interval: float = 30.0):
        self.driver = driver
        self.backend = backend
        self.interval = interval
        # boot-time chip set: a chip whose sysfs entry vanishes
        # entirely must still be reported failed
        self._expected = frozenset(
            c.index for c in driver.state.topology.chips)
        self._publish_pending = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # change subscribers: called with the full unhealthy dict on
        # every transition, BEFORE the republish attempt, so node-local
        # consumers (the fleet gateway's replica drain,
        # gateway/replica.py; the elastic gang supervisor's worker
        # eviction, parallel/supervisor.py GangSupervisor.attach; and
        # the fleet reconciler's supply ledger, fleet/supply.py
        # ChipLedger.on_health — its heal bookkeeping is what drives
        # gang regrow) see a chip-down even when the apiserver is
        # unreachable — their reaction is local, the republish is not.
        # Callbacks must not raise; one failing listener must not
        # starve the republish or its siblings.
        self.listeners: list = []

    # -- one observation ---------------------------------------------------

    def check_once(self) -> bool:
        """Returns True when the unhealthy set changed (and the
        ResourceSlices were republished)."""
        try:
            unhealthy = self.backend.health(expected=self._expected)
        except Exception:
            log.exception("health probe failed; keeping last state")
            return False
        state = self.driver.state
        before = dict(state.unhealthy)
        changed = state.apply_health(unhealthy)
        # driver.publish_pending: the boot-time publication queue gave
        # up after its bounded retries (driver.py _queue_publish) — the
        # periodic reconcile here owns the republish from then on
        if not changed and not self._publish_pending \
                and not getattr(self.driver, "publish_pending", False):
            return False
        for idx, reason in sorted(unhealthy.items()):
            if before.get(idx) != reason:
                log.warning("chip %d unhealthy: %s", idx, reason)
        for idx in sorted(set(before) - set(unhealthy)):
            log.info("chip %d healthy again", idx)
        if changed:
            for listener in list(self.listeners):
                try:
                    listener(dict(unhealthy))
                except Exception:
                    log.exception("health listener failed")
        try:
            self.driver.metrics.unhealthy_chips.set(len(unhealthy))
            self.driver.publish_resources()
        except Exception:
            # apply_health already narrowed the local set; remember to
            # republish next tick so a transient API outage cannot
            # leave stale ResourceSlices advertising a dead chip
            self._publish_pending = True
            log.exception("republish after health change failed; will "
                          "retry next poll")
            return False
        self._publish_pending = False
        log.info("republished ResourceSlices: %d allocatable devices, "
                 "%d unhealthy chips", len(state.allocatable),
                 len(unhealthy))
        return True

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self.interval <= 0 or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="tpu-health-monitor", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.check_once()
            except Exception:   # the monitor must outlive any surprise
                log.exception("health check failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
