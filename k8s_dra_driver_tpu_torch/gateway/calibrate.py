"""One shared definition of "self-calibrated capacity".

The port of ``k8s_dra_driver_tpu/gateway/calibrate.py``.  Every
serving probe states offered load as a MULTIPLE of the pool's own
measured drain rate, so "offered load at four times the measured drain
rate" is machine-relative and means the same thing on the CPU and on
the card.  gateway/probe.py and
serving_disagg/probe.py both call this one helper, so their
``base_rps`` is computed identically.

At least TWO all-at-once drains through FRESH pools: the first pays
every one-time cost (kernel library load, allocator growth, the first
launch of each shape), only the LAST is timed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Capacity:
    """The calibrated view: ``base_rps`` (warm all-at-once drain rate)
    and ``service_s`` (mean per-request service time) — offered loads
    and SLOs scale from these."""

    n_requests: int
    wall_s: float
    base_rps: float
    service_s: float

    def slo_s(self, slo_x: float) -> float:
        """An SLO of ``slo_x`` calibrated service times."""
        return slo_x * self.service_s


def calibrate_capacity(make_gateway: Callable[[], object],
                       make_requests: Callable[[str], list],
                       rounds: int = 2) -> Capacity:
    """Measure a pool's warm drain rate.

    ``make_gateway()`` builds a FRESH gateway+pool per round (warm
    rounds must not leave prefix caches or queues behind for the
    timed one); ``make_requests(tag)`` builds the request list with
    ``tag``-prefixed uids so rounds never collide on the duplicate-uid
    contract.  All rounds drain all-at-once (submit everything, pump
    until idle); only the LAST is timed.
    """
    if rounds < 2:
        raise ValueError("calibration needs >= 2 rounds: the first "
                         "drain pays the one-time costs")
    wall = 0.0
    n = 0
    for i in range(rounds):
        gw = make_gateway()
        reqs = make_requests(f"cal{i}_")
        for req in reqs:
            gw.submit(req)
        t0 = time.perf_counter()
        gw.run_until_idle()
        wall = time.perf_counter() - t0
        n = len(reqs)
    return Capacity(n_requests=n, wall_s=wall,
                    base_rps=n / wall, service_s=wall / n)


__all__ = ["Capacity", "calibrate_capacity"]
