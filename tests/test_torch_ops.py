"""Port attention operators (k8s_dra_driver_tpu_torch/ops) against the
JAX package's.

The same numpy inputs go through the JAX function and its port.  The
JAX Pallas kernels run as the JAX package's own tests run them on the
CPU (interpret mode); the port's wrappers take their plain PyTorch
versions, because every tensor here lies on the CPU.  f32 throughout:
the tolerance (atol 1e-5) covers summation order and the online
softmax of the interpreted kernels, nothing more.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.ops.ring_attention import (
    attention_reference as jax_attention_reference)
from k8s_dra_driver_tpu_torch.ops import _build
from k8s_dra_driver_tpu_torch.ops import flash_attention as tfa
from k8s_dra_driver_tpu_torch.ops import paged_attention as tpa
from k8s_dra_driver_tpu_torch.ops.ring_attention import (
    attention_reference)

# the JAX package's ops/__init__ re-exports functions under the module
# names, so the modules are fetched explicitly
jfa = importlib.import_module("k8s_dra_driver_tpu.ops.flash_attention")
jpa = importlib.import_module("k8s_dra_driver_tpu.ops.paged_attention")

ATOL = 1e-5


def qkv(seed, b, t, h, h_kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d), np.float32)
    k = rng.standard_normal((b, t, h_kv, d), np.float32)
    v = rng.standard_normal((b, t, h_kv, d), np.float32)
    return q, k, v


def segments(seed, b, t):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 5, (b, t)) == 0
    return np.cumsum(starts, axis=1).astype(np.int32)


def to_t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CASES = {
    "causal_mha": dict(h=4, h_kv=4, causal=True, window=None, seg=False),
    "causal_gqa": dict(h=4, h_kv=2, causal=True, window=None, seg=False),
    "mqa_window": dict(h=4, h_kv=1, causal=True, window=5, seg=False),
    "gqa_segments": dict(h=4, h_kv=2, causal=True, window=None, seg=True),
    "noncausal_segments": dict(h=2, h_kv=1, causal=False, window=None,
                               seg=True),
    "window_segments": dict(h=4, h_kv=2, causal=True, window=7, seg=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_reference_matches_jax(name):
    c = CASES[name]
    q, k, v = qkv(1, 2, 24, c["h"], c["h_kv"], 16)
    seg = segments(2, 2, 24) if c["seg"] else None
    want = jax_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=c["causal"], window=c["window"],
        segment_ids=None if seg is None else jnp.asarray(seg))
    tq, tk, tv = to_t(q, k, v)
    got = attention_reference(
        tq, tk, tv, causal=c["causal"], window=c["window"],
        segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["causal_gqa", "mqa_window",
                                  "gqa_segments", "window_segments"])
def test_flash_attention_matches_jax_interpret(name):
    c = CASES[name]
    t = 64 if name == "causal_gqa" else 40
    q, k, v = qkv(3, 2, t, c["h"], c["h_kv"], 16)
    seg = segments(4, 2, t) if c["seg"] else None
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=c["causal"], window=c["window"], interpret=True,
        segment_ids=None if seg is None else jnp.asarray(seg))
    tq, tk, tv = to_t(q, k, v)
    before = tfa.launches
    got = tfa.flash_attention(
        tq, tk, tv, causal=c["causal"], window=c["window"],
        segment_ids=None if seg is None else torch.from_numpy(seg))
    assert tfa.launches == before          # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flash_lse_is_logsumexp_of_scaled_masked_scores():
    q, k, v = qkv(5, 1, 12, 2, 2, 8)
    tq, tk, tv = to_t(q, k, v)
    out, lse = tfa.flash_forward(tq, tk, tv, causal=True)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * 8 ** -0.5
    s = np.where(np.tril(np.ones((12, 12), bool))[None, None], s, -np.inf)
    np.testing.assert_allclose(lse.numpy(),
                               np.logaddexp.reduce(s, axis=-1),
                               atol=ATOL)
    np.testing.assert_allclose(
        out.numpy(), attention_reference(tq, tk, tv).numpy(), atol=ATOL)


@pytest.mark.parametrize("kwargs,match", [
    (dict(window=0), "window requires causal"),
    (dict(window=4, causal=False), "window requires causal"),
])
def test_flash_window_validation_matches_jax(kwargs, match):
    q, k, v = qkv(6, 1, 8, 2, 1, 8)
    with pytest.raises(ValueError, match=match):
        jax_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kwargs)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(*to_t(q, k, v), **kwargs)


def test_flash_shape_validation():
    q, k, v = qkv(7, 1, 8, 3, 2, 8)
    with pytest.raises(ValueError, match="not a multiple"):
        tfa.flash_attention(*to_t(q, k, v))
    q, k, v = qkv(7, 1, 8, 4, 2, 8)
    tq, tk, tv = to_t(q, k, v)
    with pytest.raises(ValueError, match="dtypes differ"):
        tfa.flash_attention(tq, tk.double(), tv)
    with pytest.raises(ValueError, match="segment_ids"):
        tfa.flash_attention(tq, tk, tv,
                            segment_ids=torch.zeros((1, 7), dtype=torch.int32))


def test_wrappers_refuse_devices_other_than_cuda_and_cpu():
    q = torch.empty((1, 8, 2, 64), device="meta")
    k = torch.empty((1, 8, 1, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_forward(q, k, k)
    qd = torch.empty((2, 2, 64), device="meta")
    pool = torch.empty((3, 4, 1, 64), device="meta")
    tables = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    lengths = torch.ones((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpa.paged_attention(qd, pool, pool, tables, lengths)


def paged_case(seed, b, h, h_kv, d, bs, n_pages, lengths):
    """Random pool + shuffled, non-contiguous block tables whose unused
    slots point at the null block 0."""
    rng = np.random.default_rng(seed)
    nb = b * n_pages + 1
    k_pool = rng.standard_normal((nb, bs, h_kv, d), np.float32)
    v_pool = rng.standard_normal((nb, bs, h_kv, d), np.float32)
    q = rng.standard_normal((b, h, d), np.float32)
    perm = rng.permutation(nb - 1) + 1
    tables = perm[:b * n_pages].reshape(b, n_pages).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    for i in range(b):
        tables[i, -(-int(lengths[i]) // bs):] = 0
    return q, k_pool, v_pool, tables, lengths


@pytest.mark.parametrize("h,h_kv,bs,lengths", [
    (4, 4, 8, [1, 8, 9, 24]),
    (4, 2, 8, [3, 16, 17, 23]),
    (8, 2, 16, [1, 31, 32, 48]),
    (4, 1, 4, [5, 4, 12, 1]),
])
def test_paged_attention_matches_jax(h, h_kv, bs, lengths):
    n_pages = -(-max(lengths) // bs) + 1
    q, kp, vp, tables, lens = paged_case(h * 7 + bs, 4, h, h_kv, 16, bs,
                                         n_pages, lengths)
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    want_ref = jpa.paged_attention_reference(*args)
    want_kernel = jpa.paged_attention(*args, interpret=True)
    before = tpa.launches
    got = tpa.paged_attention(*to_t(q, kp, vp, tables, lens))
    assert tpa.launches == before          # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref),
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               atol=2e-4)  # the JAX kernel test's bound


PAGED_BAD = {
    "q_rank": (lambda q, kp, vp, t, ln: (q[0], kp, vp, t, ln),
               "q must be"),
    "pools": (lambda q, kp, vp, t, ln: (q, kp, vp[:1], t, ln),
              "pools must be matching"),
    "head_dim": (lambda q, kp, vp, t, ln: (q[..., :8], kp, vp, t, ln),
                 "head dim mismatch"),
    "heads": (lambda q, kp, vp, t, ln: (q[:, :3], kp, vp, t, ln),
              "not a multiple"),
    "tables": (lambda q, kp, vp, t, ln: (q, kp, vp, t[:1], ln),
               "tables must be"),
    "lengths": (lambda q, kp, vp, t, ln: (q, kp, vp, t, ln[:1]),
                "lengths must be"),
}


@pytest.mark.parametrize("name", sorted(PAGED_BAD))
def test_paged_validation_errors_match_jax(name):
    bad, match = PAGED_BAD[name]
    q, kp, vp, tables, lens = paged_case(9, 2, 4, 2, 16, 4, 3, [3, 9])
    with pytest.raises(ValueError, match=match):
        jpa.paged_attention_reference(
            *bad(*[jnp.asarray(a) for a in (q, kp, vp, tables, lens)]))
    with pytest.raises(ValueError, match=match):
        tpa.paged_attention(*bad(*to_t(q, kp, vp, tables, lens)))


def test_kernel_build_refuses_without_nvcc(monkeypatch, tmp_path):
    """No nvcc, no library: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_kernel_build_key_covers_every_source():
    names = {p.name for p in _build._CSRC.glob("*.cu*")}
    assert {"flash_fwd.cu", "flash_bwd.cu", "paged_decode.cu",
            "flash_fwd_sm90.cu", "gmm_sm90.cu", "gmm_dw_sm90.cu",
            "int8_matmul_sm90.cu", "sm90.cuh", "common.cuh"} <= names
    assert {p.name for p in _build._sources()} >= {"flash_fwd.cu",
                                                   "flash_bwd.cu",
                                                   "paged_decode.cu",
                                                   "flash_fwd_sm90.cu",
                                                   "gmm_sm90.cu",
                                                   "gmm_dw_sm90.cu",
                                                   "int8_matmul_sm90.cu"}
    assert {"flash_fwd_tc", "gmm_tc", "gmm_dw_tc",
            "int8_matmul"} <= set(_build._SIGNATURES)
    assert _build._digest() == _build._digest()


#: a stand-in for nvcc: a compile (``-c``) or the link (``-shared``)
#: named in $FAKE_NVCC_SLOW writes a partial output, records the pid of
#: a child that holds the output pipe, and sleeps; the others write
#: their output and end
FAKE_NVCC = """#!/bin/sh
out=""; step=compile
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift ;; -shared) step=link ;; esac
  shift
done
echo "fake nvcc $step -> $out"
printf partial > "$out"
if [ "$step" = "$FAKE_NVCC_SLOW" ]; then
  sleep 120 &
  echo $! >> "$FAKE_NVCC_PIDS"
  wait
fi
"""


@pytest.mark.parametrize("slow", ["compile", "link"])
def test_kernel_build_kills_a_compiler_past_its_deadline(monkeypatch,
                                                         tmp_path, slow):
    """A compile or link that outlives BUILD_TIMEOUT_S is killed with its
    children, the build directory goes, and the build raises with the
    log so far instead of hanging.  The slow stage gets 1 s of its
    deadline, the other a minute, so that a loaded machine's slow forks
    do not time the quick stage out."""
    import time
    from pathlib import Path
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    pids = tmp_path / "pids"
    monkeypatch.setenv("FAKE_NVCC_SLOW", slow)
    monkeypatch.setenv("FAKE_NVCC_PIDS", str(pids))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_BUILD_ROOT", tmp_path / "cuda")
    finish = _build._finish

    def budget(jobs, seconds, log):
        assert seconds == _build.BUILD_TIMEOUT_S
        linking = [label for label, _ in jobs] == ["link"]
        return finish(jobs, 1.0 if linking == (slow == "link") else 60.0,
                      log)

    monkeypatch.setattr(_build, "_finish", budget)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="passed its deadline") as err:
        _build._build(tmp_path / "cuda" / "lib")
    assert time.monotonic() - t0 < 30
    assert "killed at the deadline" in str(err.value)
    assert f"fake nvcc {slow}" in str(err.value)
    assert list((tmp_path / "cuda").iterdir()) == []   # no partial library
    sleepers = [int(p) for p in pids.read_text().split()]
    n_slow = len(_build._sources()) if slow == "compile" else 1
    assert len(sleepers) == n_slow
    for pid in sleepers:
        # gone, or a zombie its new parent has not reaped yet
        stat = Path(f"/proc/{pid}/stat")
        assert not stat.exists() or stat.read_text().split(")")[1].split()[
            0] == "Z", f"child {pid} of a killed compiler still runs"
