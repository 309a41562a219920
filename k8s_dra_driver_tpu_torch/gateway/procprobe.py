"""Multi-process control-plane scaling probe.

The port of ``k8s_dra_driver_tpu/gateway/procprobe.py``.  The
single-process ceiling probe (gateway/ctlprobe.py) cannot scale
admissions: every pump shares one interpreter lock.  This probe
measures the escape: the same null-engine drive against a
:class:`~.procpump.ProcessGateway`, whose pumps are real OS processes.
Each pump runs the closed-loop drive over its OWN arrival shard via
the worker-local ``replay`` op — the conductor stays out of the
per-request path entirely, so what is measured is per-process
control-plane throughput (admission, routing, stepping, durable
outcome journaling).

Scaling is reported CPU-time-normalized: each pump reports its own
``time.process_time()``, and ``scaling_x`` compares the summed
per-CPU-second admission rate across widths — what a host with a core
a pump converts into wall speedup.  The wall numbers and
``host_cpus`` are recorded too, so a reader can re-derive the verdict
for their own topology.  The null engines do no device work; the pumps
still open ``device`` (default the card), as every pump does.

Run ``python -m k8s_dra_driver_tpu_torch.gateway.procprobe`` to write
``tools/ctl_multiproc_torch.json`` (``--device cpu`` for CPU pumps);
on the card the file carries the card's name and power limit
(``card``, as ``nvidia-smi`` gives them) beside the host's CPU count.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

from .procpump import ProcessGateway
from .wire import send_msg

#: pump widths swept (the acceptance ratio is widest vs 1)
PUMP_COUNTS = (1, 2, 4)
#: requests per width (total, split evenly across that width's pumps)
N_REQUESTS = 600
#: CPU-normalized scaling the acceptance criteria demand at the
#: widest sweep point (near-linear: >= 3.2x at 4 pumps)
SCALING_FLOOR = 3.2


def _drive_width(workers: int, n_requests: int, *,
                 slots: int, replicas: int,
                 queue_capacity: int, seed: int, device) -> dict:
    """One sweep point: spawn the process gateway at ``workers``
    pumps, run the worker-local closed loop on every pump
    CONCURRENTLY (all ``replay`` ops are sent before any reply is
    awaited — the pumps really do run side by side; on a multi-core
    host the wall numbers would show it), and fold the per-pump
    reports."""
    per = n_requests // workers
    with tempfile.TemporaryDirectory() as td:
        with ProcessGateway(td, workers=workers, engine="null",
                            replicas=replicas, slots=slots,
                            queue_capacity=queue_capacity,
                            seed=seed, device=device) as gw:
            t0 = time.perf_counter()
            for i, h in enumerate(gw.handles):
                send_msg(h.proc.stdin, {
                    "id": h.next_id(), "op": "replay",
                    "tag": f"w{workers}p{i}-", "n": per,
                    "capacity": queue_capacity,
                    "slo_s": 900.0, "prompt_len": 12,
                    "prefix_families": 8, "seed": seed + i})
            reports = []
            for h in gw.handles:
                # deadline: recv is deadline-bounded inside _rpc-style
                # waits; here the replay budget bounds the whole drive
                reports.append(h.reader.recv(timeout_s=300.0))
            wall_s = time.perf_counter() - t0
            for r in reports:
                if not r.get("ok"):
                    raise RuntimeError(f"replay failed: {r}")
    outcomes: dict[str, int] = {}
    for r in reports:
        for status, n in r["outcomes"].items():
            outcomes[status] = outcomes.get(status, 0) + n
    cpu_rate = sum(r["admissions_total"] / r["cpu_s"]
                   for r in reports if r["cpu_s"] > 0)
    fsync_ms = sorted(ms for r in reports for ms in r["fsync_ms"])
    return {
        "pumps": workers,
        "n_requests": per * workers,
        "wall_s": round(wall_s, 4),
        "cpu_s_per_pump": [round(r["cpu_s"], 4) for r in reports],
        "admissions_total": sum(r["admissions_total"]
                                for r in reports),
        "routes_total": sum(r["routes_total"] for r in reports),
        "admissions_per_wall_s": round(
            sum(r["admissions_total"] for r in reports) / wall_s, 1),
        "admissions_per_cpu_s": round(cpu_rate, 1),
        "outcomes": outcomes,
        "fsync_count": len(fsync_ms),
        "fsync_ms_p50": (round(float(np.median(fsync_ms)), 4)
                         if fsync_ms else 0.0),
    }


def multiproc_probe(pump_counts=PUMP_COUNTS,
                    n_requests: int = N_REQUESTS, *,
                    slots: int = 8, replicas: int = 2,
                    queue_capacity: int = 64,
                    seed: int = 0, device="cuda") -> dict:
    """Sweep pump widths; verdict = CPU-normalized scaling at the
    widest point vs width 1, with outcome counts required IDENTICAL
    at every width (same work, different decomposition — the
    correctness half of the scaling claim)."""
    levels = [_drive_width(w, n_requests, slots=slots,
                           replicas=replicas,
                           queue_capacity=queue_capacity, seed=seed,
                           device=device)
              for w in pump_counts]
    base = levels[0]["admissions_per_cpu_s"]
    top = levels[-1]
    scaling_x = top["admissions_per_cpu_s"] / base if base else 0.0
    counts_equal = all(lv["outcomes"] == levels[0]["outcomes"]
                       for lv in levels)
    fsync_all = sorted(ms for lv in levels
                       for ms in [lv["fsync_ms_p50"]]
                       if lv["fsync_count"])
    # the acceptance bar is 0.8x-per-process linearity: at the
    # recorded 4-pump shape that IS the 3.2x floor; a narrower sweep
    # (the hermetic smoke shape stops at 2 pumps) is held to the same
    # per-process bar, not the 4-pump absolute
    floor = SCALING_FLOOR / 4.0 * pump_counts[-1]
    result = {
        "pump_counts": list(pump_counts),
        "n_requests": n_requests,
        "host_cpus": os.cpu_count(),
        "levels": levels,
        "admissions_per_s": top["admissions_per_cpu_s"],
        "scaling_x": round(scaling_x, 3),
        "outcome_counts_equal": counts_equal,
        "outcome_fsync_ms": (round(float(np.median(fsync_all)), 4)
                             if fsync_all else 0.0),
        "scaling_floor": round(floor, 3),
        "valid": bool(counts_equal and scaling_x >= floor
                      and len(pump_counts) >= 2),
        "note": (
            "admissions_per_s and scaling_x are CPU-time-normalized "
            "(sum over pumps of admissions / process_time): wall-clock "
            f"rates on this {os.cpu_count()}-CPU host also depend on "
            "how many cores the pumps get; the per-CPU-second rate is "
            "what a host with a core a pump converts into wall "
            "speedup (no shared interpreter lock). Wall numbers are "
            "recorded per level for re-derivation."),
    }
    return result


def card() -> str | None:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them;
    None without ``nvidia-smi``."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else None


def main(out_path: str | None = None, device="cuda") -> dict:
    out = {
        "probe": "control_plane_multiproc",
        "host": platform.machine(),
        "device": str(device),
        "card": card() if str(device).startswith("cuda") else None,
        "result": multiproc_probe(device=device),
    }
    path = Path(out_path or Path(__file__).resolve()
                .parents[2] / "tools" / "ctl_multiproc_torch.json")
    path.write_text(json.dumps(out, indent=2, sort_keys=True) + "\n")
    print(json.dumps({"written": str(path),
                      "scaling_x": out["result"]["scaling_x"],
                      "valid": out["result"]["valid"]}))
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(prog="procprobe")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.out, a.device)


__all__ = ["PUMP_COUNTS", "SCALING_FLOOR", "main", "multiproc_probe"]
