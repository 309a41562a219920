"""Open-loop trace-replay load generation for the serving control
plane.

The port of ``k8s_dra_driver_tpu/gateway/loadgen.py``, whole.
**Open-loop** arrivals have their times fixed IN ADVANCE by a trace:
a saturated pool delays nothing, the backlog is real, and overload
converts into explicit shed/reject outcomes instead of silently
stretched interarrivals (the evaluation discipline of Orca, DistServe
and AlpaServe).

Traces are checked-in fixtures (``gateway/traces/*.json``, the
reference's files copied byte for byte), each a unit-mean normalized
interarrival sequence regenerable bit-for-bit from its recorded seed
by :func:`generate_trace`:

- ``bursty``   — geometric bursts of near-simultaneous arrivals
                 separated by long exponential gaps;
- ``diurnal``  — sinusoidal rate modulation with exponential jitter;
- ``heavy_tail`` — Pareto(α=1.5) interarrivals, capped.

Replay scales a trace by ``offered_x * base_rps`` where ``base_rps``
comes from the shared calibration helper (gateway/calibrate.py), so
"bursty, replayed at twenty times the measured drain rate" is
machine-relative.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TRACE_DIR = Path(__file__).parent / "traces"
TRACE_NAMES = ("bursty", "diurnal", "heavy_tail")

#: every fixture carries exactly these keys
TRACE_SCHEMA_KEYS = frozenset(
    {"name", "kind", "seed", "n", "unit_mean", "interarrivals",
     "tenants", "adapters", "note"})

_FIXTURE_SEEDS = {"bursty": 7, "diurnal": 11, "heavy_tail": 13}
_FIXTURE_N = 96

#: per-arrival tenant tags (multi-tenant fleets): three generic tenant labels with a fixed skew — replays tag each
#: submit so the per-tenant gateway series populate; drawn AFTER the
#: interarrivals from the same seeded stream, so adding them changed
#: no arrival time in any fixture
_TENANT_LABELS = ("a", "b", "c")
_TENANT_WEIGHTS = (0.5, 0.3, 0.2)

#: per-arrival adapter tags (multi-adapter serving, serving_lora/):
#: a base-model majority plus three LoRA labels with a fixed skew —
#: drawn AFTER the tenants from the same seeded stream, so adding
#: them changed no arrival time and no tenant tag in any fixture.
#: ``"base"`` means Request.adapter=None at replay.
_ADAPTER_LABELS = ("base", "lora-a", "lora-b", "lora-c")
_ADAPTER_WEIGHTS = (0.4, 0.3, 0.2, 0.1)


def generate_trace(name: str, n: int = _FIXTURE_N,
                   seed: int | None = None) -> dict:
    """Regenerate a trace deterministically (the checked-in fixtures
    are exactly ``generate_trace(name)``, so the fixture files can
    always be audited against this code)."""
    if seed is None:
        seed = _FIXTURE_SEEDS[name]
    rng = np.random.default_rng(seed)
    if name == "bursty":
        gaps: list[float] = []
        while len(gaps) < n:
            for _ in range(int(rng.integers(3, 9))):
                gaps.append(float(rng.exponential(0.05)))
            gaps.append(float(rng.exponential(4.0)))
        arr = np.asarray(gaps[:n])
    elif name == "diurnal":
        i = np.arange(n)
        rate = 1.0 + 0.8 * np.sin(2.0 * np.pi * i / n)
        arr = rng.exponential(1.0, n) / np.maximum(rate, 0.2)
    elif name == "heavy_tail":
        arr = np.minimum(rng.pareto(1.5, n), 50.0)
    else:
        raise ValueError(f"unknown trace {name!r}; "
                         f"have {TRACE_NAMES}")
    arr = arr / arr.mean()          # unit mean: offered_x is exact
    tenants = [str(t) for t in rng.choice(
        _TENANT_LABELS, size=n, p=_TENANT_WEIGHTS)]
    adapters = [str(a) for a in rng.choice(
        _ADAPTER_LABELS, size=n, p=_ADAPTER_WEIGHTS)]
    return {
        "name": name,
        "kind": "interarrival",
        "seed": seed,
        "n": n,
        "unit_mean": 1.0,
        "interarrivals": [round(float(g), 6) for g in arr],
        "tenants": tenants,
        "adapters": adapters,
        "note": ("unit-mean normalized interarrivals; replay scales "
                 "by offered_x * calibrated base_rps "
                 "(gateway/calibrate.py); per-arrival tenant tags "
                 "skewed 0.5/0.3/0.2; adapter tags skewed "
                 "0.4/0.3/0.2/0.1 with 'base' = no adapter; "
                 "regenerable via "
                 f"generate_trace({name!r})"),
    }


def load_trace(name: str) -> dict:
    """Read a checked-in fixture and validate its schema."""
    path = TRACE_DIR / f"{name}.json"
    trace = json.loads(path.read_text())
    missing = TRACE_SCHEMA_KEYS - set(trace)
    if missing:
        raise ValueError(f"trace {name!r} missing keys {missing}")
    if not trace["interarrivals"]:
        raise ValueError(f"trace {name!r} is empty")
    return trace


# VirtualClock lives in sim/clock.py; re-exported here (and in
# __all__), as the reference does.
from ..sim.clock import VirtualClock  # noqa: E402


def replay(gateway, trace: dict, *, offered_x: float,
           base_rps: float, make_request, n_requests: int | None = None,
           slo_s: float | None = None, clock=None, sleep=None,
           max_steps: int = 500_000) -> dict:
    """Replay ``trace`` open-loop through ``gateway`` (a FleetGateway
    or ShardedGateway — anything with ``submit``/``step``/``pending``).

    Arrival times are computed UP FRONT from the trace's interarrivals
    at ``offered_x * base_rps`` and never adjusted: if the pump falls
    behind, due arrivals are submitted in a burst on the next loop
    iteration — exactly the backlog an open-loop harness exists to
    create.  ``make_request(i)`` supplies the i-th request (the trace
    cycles if ``n_requests`` exceeds its length).  With a
    :class:`VirtualClock`, pass ``clock=vc`` and ``sleep=vc.sleep``
    (and build the gateway with ``clock=vc``) for a deterministic
    hermetic run; default is wall time.
    """
    import time as _time
    clock = clock or _time.perf_counter
    sleep = sleep or _time.sleep
    gaps = trace["interarrivals"]
    tenants = trace.get("tenants") or None
    n = n_requests if n_requests is not None else len(gaps)
    rate = offered_x * base_rps
    t0 = clock()
    sched, t = [], t0
    for i in range(n):
        t += gaps[i % len(gaps)] / rate
        sched.append(t)
    i = steps = 0
    while True:
        now = clock()
        while i < n and now >= sched[i]:
            if tenants is not None:
                gateway.submit(make_request(i), slo_s=slo_s,
                               tenant=tenants[i % len(tenants)])
            else:
                gateway.submit(make_request(i), slo_s=slo_s)
            i += 1
        gateway.step()
        steps += 1
        if steps > max_steps:
            raise RuntimeError(
                f"trace replay not done after {max_steps} steps")
        busy = gateway.pending() or any(
            r.in_flight for r in gateway.manager.replicas)
        if i >= n and not busy:
            break
        if i < n and not busy:
            sleep(max(0.0, sched[i] - clock()))
    return {
        "trace": trace["name"],
        "submitted": n,
        "offered_x": offered_x,
        "offered_rps": rate,
        "wall_s": clock() - t0,
        "steps": steps,
    }


def write_fixtures(directory: Path | None = None) -> list[Path]:
    """(Re)write the checked-in fixtures from the generators — run
    after changing a generator, never edit the JSON by hand."""
    directory = directory or TRACE_DIR
    directory.mkdir(parents=True, exist_ok=True)
    out = []
    for name in TRACE_NAMES:
        path = directory / f"{name}.json"
        path.write_text(json.dumps(generate_trace(name), indent=1)
                        + "\n")
        out.append(path)
    return out


__all__ = ["TRACE_DIR", "TRACE_NAMES", "TRACE_SCHEMA_KEYS",
           "VirtualClock", "generate_trace", "load_trace", "replay",
           "write_fixtures"]
