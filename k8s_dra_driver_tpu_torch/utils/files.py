"""Small file-IO helpers shared across daemon and client sides (the
port's copy of ``k8s_dra_driver_tpu/utils/files.py``)."""

from __future__ import annotations

import os
import time
from pathlib import Path


def atomic_write(path: Path, text: str) -> None:
    """Write-then-rename so concurrent readers never observe torn
    content (the coordination-dir contract: every published file is
    either absent or complete)."""
    tmp = path.with_name(f".{path.name}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


#: adaptive-watch envelope for :func:`wait_for_file`: sub-ms first
#: check (a ready daemon publishes within tens of ms, and a coarse
#: poll sleep, not work, set the coordinated-shared prepare floor).  The cap stays LOW (2 ms): a stat() costs ~1 µs, so even
#: a full budget of 2 ms polls is negligible CPU, while a coarser cap
#: adds its own width to every observation — with a 20 ms cap the last
#: doubling overshot a file landing at ~10 ms by up to 6 ms, which was
#: a measurable slice of the coordinated-shared prepare p50.
WATCH_START_S = 0.0002
WATCH_CAP_S = 0.002


def wait_for_file(path: Path, budget_s: float = 2.0,
                  sleep=time.sleep) -> bool:
    """Adaptive watch for ``path`` to exist; True if it appeared
    within ``budget_s`` of cumulative sleep.

    The inotify-grade alternative to a fixed readiness sleep: an
    exponential sub-ms ramp makes an already-present or
    milliseconds-away file visible near-instantly, while the cap keeps
    a genuinely slow writer as cheap to wait on as a coarse poll.  The
    budget is STEP-bounded (delays sum to ``budget_s``), not
    wall-clock-bounded, so hermetic beds that inject a no-op ``sleep``
    pay a few dozen stat() calls instead of spinning a real-time
    deadline."""
    delay = WATCH_START_S
    slept = 0.0
    while True:
        if path.exists():
            return True
        if slept >= budget_s:
            return False
        delay = min(delay, budget_s - slept)
        sleep(delay)
        slept += delay
        delay = min(delay * 2.0, WATCH_CAP_S)
