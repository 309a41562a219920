"""Workload-side profiling: Chrome traces and device memory snapshots.

The port of ``k8s_dra_driver_tpu/utils/profiling.py``.  Capture a trace
of a training or serving region, annotate phases so they are findable
in the timeline, and snapshot device memory.  Thin by design:
``torch.profiler`` already records the host's ops and, on a card, every
CUDA kernel with its device time (CUPTI); wrapping it keeps the call
sites uniform and testable.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import pickle
from pathlib import Path

import torch

_TRACE_SEQ = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Capture everything inside the block as a Chrome trace
    (``chrome://tracing`` or Perfetto) written under ``log_dir`` as
    ``trace-<pid>-<n>.json``.  Host ops always; CUDA kernels too when a
    card is present.  The trace is written and the profiler stopped
    even when the block raises; keep regions to a few steps, traces
    are verbose.  Yields the ``torch.profiler.profile`` object."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            str(log_dir / f"trace-{os.getpid()}-{next(_TRACE_SEQ)}.json"))


def annotate(name: str):
    """Name a region inside an active trace (a span in the timeline):
    ``with annotate("train-step"): ...``."""
    return torch.profiler.record_function(name)


def device_memory_profile(path: str | Path, device="cuda") -> Path:
    """Write a snapshot of the card's allocator (``torch.cuda.memory
    ._snapshot()``: every segment and block live on the device right
    now, pickled; ``torch.cuda.memory``'s viewer reads it), the OOM
    post-mortem tool.  Raises on the CPU: there is no device memory to
    snapshot there (the reference's CPU backend has a host allocator
    profile instead)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"device_memory_profile needs a CUDA device, got {dev}"
            + ("" if torch.cuda.is_available() else
               " (CUDA is not available)")
            + ": there is no device memory to snapshot on the CPU")
    path = Path(path)
    with torch.cuda.device(dev):
        snapshot = torch.cuda.memory._snapshot()
    path.write_bytes(pickle.dumps(snapshot))
    return path


__all__ = ["annotate", "device_memory_profile", "trace"]
