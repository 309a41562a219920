"""The port's profiling helpers (k8s_dra_driver_tpu_torch/utils/
profiling.py) on the CPU, the twins of tests/test_profiling.py.

``trace`` writes a Chrome trace (torch.profiler) that holds the
``annotate`` span, and stops on error so the next trace starts cleanly.
``device_memory_profile`` snapshots the card's allocator; on the CPU,
where there is no device memory, it raises (the reference's CPU backend
writes a host allocator profile instead: ROADMAP Queue C).  On the card
``chip_smoke.py``'s ``phase_measure`` holds the trace to the K1 kernel's
name and the snapshot to a non-empty file.
"""

import json

import pytest
import torch

from k8s_dra_driver_tpu_torch.utils.profiling import (annotate,
                                                      device_memory_profile,
                                                      trace)


def _events(logdir):
    produced = sorted(logdir.glob("*.json"))
    assert produced, f"no Chrome trace under {logdir}"
    assert produced[0].stat().st_size > 0
    return json.loads(produced[0].read_text())["traceEvents"]


def test_trace_writes_chrome_trace(tmp_path):
    logdir = tmp_path / "prof"
    with trace(logdir):
        with annotate("matmul-region"):
            x = torch.ones((64, 64))
            (x @ x).sum()
    names = {e.get("name") for e in _events(logdir)}
    assert "matmul-region" in names
    assert any(n and "mm" in n for n in names)


def test_trace_stops_on_error(tmp_path):
    logdir = tmp_path / "prof"
    with pytest.raises(RuntimeError, match="boom"):
        with trace(logdir):
            with annotate("doomed"):
                raise RuntimeError("boom")
    assert "doomed" in {e.get("name") for e in _events(logdir)}
    # a second trace starts cleanly (the first was stopped)
    with trace(tmp_path / "prof2") as prof:
        torch.zeros(4).sum()
    assert prof is not None
    _events(tmp_path / "prof2")


def test_device_memory_profile_needs_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="no device memory"):
        device_memory_profile(tmp_path / "mem.pickle", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_memory_profile(tmp_path / "mem.pickle")
    assert not (tmp_path / "mem.pickle").exists()
