"""The JAX package's last public names in the port, against the JAX
functions where both run here: ``visible_chip_count`` and ``log2_int``
(parallel/mesh.py), the launch-site trace annotations of
utils/dispatch.py, and the package's ``DRIVER_NAME``."""

import contextlib

import pytest
import torch

import k8s_dra_driver_tpu as jpkg
import k8s_dra_driver_tpu_torch as tpkg
from k8s_dra_driver_tpu.parallel import mesh as jmesh
from k8s_dra_driver_tpu_torch import parallel as tparallel
from k8s_dra_driver_tpu_torch.parallel import mesh as tmesh
from k8s_dra_driver_tpu_torch.utils import dispatch, profiling

UUIDS = "GPU-1b2c3d4e-0000-1111-2222-333344445555,GPU-aa,GPU-bb"


@pytest.mark.parametrize("chips", ["0", "0,1,2,3", "4,5,", ",0,,1"])
def test_visible_chip_count_counts_tpu_chips_as_jax_does(chips):
    """A TPU claim's ``TPU_VISIBLE_CHIPS`` is counted entry by entry, as
    the JAX function counts it, whatever else the env holds."""
    env = {"TPU_VISIBLE_CHIPS": chips, "CUDA_VISIBLE_DEVICES": UUIDS}
    assert tmesh.visible_chip_count(env) == jmesh.visible_chip_count(env)
    assert tmesh.visible_chip_count(env) == len(
        [x for x in chips.split(",") if x])


@pytest.mark.parametrize("value,want", [
    (UUIDS, 3), ("GPU-aa", 1), (" GPU-aa, GPU-bb", 2),
    ("GPU-aa,MIG-cc", 1)])
def test_visible_chip_count_counts_the_claims_gpu_uuids(value, want):
    """An NVIDIA claim's spec sets ``CUDA_VISIBLE_DEVICES`` to the cards'
    UUIDs (the port's plugin contract): those are counted."""
    assert tmesh.visible_chip_count({"CUDA_VISIBLE_DEVICES": value}) == want


@pytest.mark.parametrize("env", [{}, {"CUDA_VISIBLE_DEVICES": "0,1"},
                                 {"TPU_VISIBLE_CHIPS": ""}])
def test_visible_chip_count_falls_back_to_the_cards_torch_sees(env,
                                                               monkeypatch):
    """Neither variable names a claim: the count is the cards torch
    sees (none here); an empty env reads the process's."""
    monkeypatch.delenv("TPU_VISIBLE_CHIPS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 5)
    assert tmesh.visible_chip_count(env) == 5
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", "0,1")
    if not env:          # the process environment, as in JAX
        assert tmesh.visible_chip_count(env) == 2


def test_visible_chip_count_and_log2_int_are_exported():
    assert tparallel.visible_chip_count is tmesh.visible_chip_count
    assert tparallel.log2_int is tmesh.log2_int
    assert "visible_chip_count" in tparallel.__all__
    assert "log2_int" in tparallel.__all__


@pytest.mark.parametrize("n", [1, 2, 8, 1024])
def test_log2_int_matches_jax(n):
    assert tmesh.log2_int(n) == jmesh.log2_int(n)


@pytest.mark.parametrize("n", [3, 6, 1000])
def test_log2_int_refuses_what_jax_refuses(n):
    with pytest.raises(AssertionError, match="power of two"):
        jmesh.log2_int(n)
    with pytest.raises(AssertionError, match="power of two"):
        tmesh.log2_int(n)


def test_driver_name_is_the_jax_packages():
    assert tpkg.DRIVER_NAME == jpkg.DRIVER_NAME == "tpu.google.com"


@pytest.fixture
def ranges(monkeypatch):
    """The names of the profiler ranges opened, through
    ``profiling.annotate``."""
    opened = []

    def annotate(name):
        opened.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(profiling, "annotate", annotate)
    yield opened
    dispatch.enable_annotations(False)


def test_annotations_are_off_by_default(ranges):
    assert dispatch.ANNOTATE is False
    fn = dispatch.counted("some_launch")(lambda x: x + 1)
    assert fn(1) == 2
    with dispatch.annotated("phase"):
        pass
    assert ranges == []


def test_enabled_annotations_name_each_counted_launch(ranges):
    dispatch.enable_annotations()
    assert dispatch.ANNOTATE is True
    fn = dispatch.counted("some_launch")(lambda x: x + 1)
    with dispatch.track() as t:
        assert fn(1) == 2
        with dispatch.annotated("prefill_export"):
            fn(2)
    assert ranges == ["some_launch", "prefill_export", "some_launch"]
    assert t.by_label == {"some_launch": 2}
    dispatch.enable_annotations(False)
    fn(3)
    assert len(ranges) == 3


def test_annotate_is_a_torch_profiler_range():
    """Under a profiler, the range shows by its label."""
    dispatch.enable_annotations()
    try:
        fn = dispatch.counted("ranged_launch")(lambda x: x * 2)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fn(torch.ones(4))
    finally:
        dispatch.enable_annotations(False)
    assert "ranged_launch" in {e.key for e in prof.key_averages()}
