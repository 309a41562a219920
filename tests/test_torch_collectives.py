"""The port's measurement harness (k8s_dra_driver_tpu_torch/ops/
collectives.py) against the JAX package's ops/collectives.py.

The twins of tests/test_collectives.py (the median over samples takes
its validity from the sample it selects), then the harness on scripted
times in both packages (``_differential_median``, ``measure_chain``,
``measure_chain_samples``: the same readings and flags), the fresh
input of every timed call, and the CPU runs of the attention, grad,
matmul and all-reduce probes with the JAX probes' keys, and
``dispatch_probe``'s counts equal to JAX's at JAX's widths.  CPU
readings are CPU readings: no floor applies, and no number here is a
device time.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from k8s_dra_driver_tpu.ops import collectives as jcol
from k8s_dra_driver_tpu_torch.ops import collectives


def _with_samples(monkeypatch, mod, outcomes):
    """Run measure_chain_samples with _measure_pair stubbed to return
    the scripted (elapsed, valid) outcomes in order."""
    it = iter(outcomes)
    monkeypatch.setattr(mod, "_measure_pair", lambda *a, **k: next(it))
    return mod.measure_chain_samples(lambda n: None, None, iters=4,
                                     samples=len(outcomes))


# -- twins of tests/test_collectives.py ------------------------------------

def test_median_prefers_valid_pool(monkeypatch):
    med, valid, runs = _with_samples(
        monkeypatch, collectives,
        [(0.002, True), (0.009, False), (0.004, True)])
    assert med == 0.002         # median_low of the valid pool {2,4}
    assert valid is True
    assert [r["valid"] for r in runs] == [True, False, True]


def test_value_collision_does_not_launder_validity(monkeypatch):
    med, valid, _ = _with_samples(
        monkeypatch, collectives,
        [(0.003, True), (0.003, False), (0.005, True)])
    assert med == 0.003 and valid is True


def test_all_invalid_pool_reports_invalid(monkeypatch):
    med, valid, runs = _with_samples(
        monkeypatch, collectives,
        [(0.004, False), (0.002, False), (0.006, False)])
    assert med == 0.004         # median_low over the fallback pool
    assert valid is False
    assert all(not r["valid"] for r in runs)


# -- the harness on scripted times, in both packages -----------------------

SCRIPTS = {
    # short, long best times in trial order
    "clean": [0.010, 0.034, 0.011, 0.035, 0.010, 0.033],
    "jitter": [0.010, 0.030, 0.030, 0.012, 0.011, 0.034],
    "swamped": [0.020, 0.010, 0.030, 0.012, 0.025, 0.013],
}


def _scripted(monkeypatch, mod, times):
    it = iter(times)
    monkeypatch.setattr(mod, "_best_time",
                        lambda fn, arg, reps=4: next(it))


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("iters,short", [(32, 8), (4, 4)])
def test_differential_median_equals_jax(monkeypatch, script, iters, short):
    got = {}
    for name, mod in (("torch", collectives), ("jax", jcol)):
        _scripted(monkeypatch, mod, SCRIPTS[script])
        got[name] = mod._differential_median(None, None, None, iters,
                                             short)
    assert got["torch"] == got["jax"]
    if script == "swamped" and iters > short:
        assert got["torch"][1] is False


@pytest.mark.parametrize("floor_s", [0.0, 0.0012])
def test_measure_chain_and_samples_equal_jax(monkeypatch, floor_s):
    """Retries, floors and the median over samples, from one script of
    best times long enough for every retry."""
    times = (SCRIPTS["swamped"] + SCRIPTS["clean"] + SCRIPTS["jitter"]) * 4
    got = {}
    for name, mod in (("torch", collectives), ("jax", jcol)):
        _scripted(monkeypatch, mod, times)
        chain = mod.measure_chain(lambda n: n, None, 32, floor_s=floor_s)
        samples = mod.measure_chain_samples(lambda n: n, None, 32,
                                            floor_s=floor_s, samples=3)
        got[name] = (chain, samples)
    assert got["torch"] == got["jax"]


def test_every_timed_call_gets_a_fresh_input():
    """One warm call on the input, then a new input each rep (the
    reference's ``arg + k``), the scalar result read back each time."""
    seen = []

    def fn(x):
        seen.append(x.clone())
        return x.sum()

    arg = torch.zeros(3, dtype=torch.int64)
    t = collectives._best_time(fn, arg, reps=3)
    assert t > 0
    assert [int(s[0]) for s in seen] == [0, 1, 2, 3]
    assert all(s.dtype == torch.int64 for s in seen)
    pair = [torch.zeros(2), torch.ones(2)]
    assert [a.tolist() for a in collectives._fresh(pair, 2)] == \
        [[2.0, 2.0], [3.0, 3.0]]


def test_ceilings_are_the_h100s_with_the_reference_headroom():
    """989 TFLOP/s bf16 and 3.35 TB/s (one H100 SXM at 700 W), times the
    reference's headroom over its own card (about 2x, 2.5x and 1.2x)."""
    assert collectives._PEAK_TFLOPS_CEILING == 2 * 989.0
    assert collectives._PEAK_HBM_GBPS_CEILING == 2.5 * 3350.0
    assert collectives._DECODE_HBM_GBPS_CEILING == 1.2 * 3350.0
    assert 1.9 < jcol._PEAK_TFLOPS_CEILING / 197 < 2.1


# -- probes on the CPU: the JAX probes' keys -------------------------------

def _keys_equal(got, want):
    assert set(got) == set(want), (set(got) ^ set(want))


@pytest.mark.parametrize("samples,kv_heads", [(1, None), (2, 1)])
def test_attention_probe_keys_equal_jax(samples, kv_heads):
    kw = dict(batch=1, seq=128, heads=2, head_dim=16, iters=2,
              kv_heads=kv_heads, samples=samples)
    got = collectives.attention_probe(dtype=torch.float32, device="cpu",
                                      **kw)
    want = jcol.attention_probe(dtype=jnp.float32, **kw)
    _keys_equal(got, want)
    for k in ("batch", "seq", "heads", "head_dim", "kv_heads", "window"):
        assert got[k] == want[k]
    assert got["flash_ms"] > 0 and got["naive_ms"] > 0
    if samples > 1:
        assert len(got["flash_ms_runs"]) == samples


def test_attention_grad_probe_keys_equal_jax():
    kw = dict(batch=1, seq=128, heads=2, head_dim=16, iters=2)
    got = collectives.attention_grad_probe(dtype=torch.float32,
                                           device="cpu", **kw)
    want = jcol.attention_grad_probe(dtype=jnp.float32, **kw)
    _keys_equal(got, want)
    assert got["valid"] in (True, False)


def test_grad_probe_body_is_the_gradient_step(monkeypatch):
    """The grad chain's body: x + 1e-3 * d(sum attn(x, k, v))/dx, the
    reference's ``jax.grad`` step, through the port's flash path."""
    from k8s_dra_driver_tpu_torch.ops.flash_attention import flash_attention
    captured = {}

    def grab(*a, **kw):
        captured["make_body"] = a[7]
        return {}

    monkeypatch.setattr(collectives, "_attention_differential", grab)
    collectives.attention_grad_probe(device="cpu")
    gen = torch.Generator().manual_seed(5)
    x, k, v = (torch.randn(1, 16, 2, 8, generator=gen) for _ in range(3))
    body = captured["make_body"](
        lambda q, k_, v_: flash_attention(q, k_, v_, causal=True), k, v)
    xr = x.clone().requires_grad_(True)
    flash_attention(xr, k, v, causal=True).float().sum().backward()
    assert torch.allclose(body(x), x + xr.grad * 1e-3)


def test_matmul_and_allreduce_keys_equal_jax():
    got = collectives.matmul_tflops(dim=64, iters=8, dtype=torch.float32,
                                    device="cpu")
    _keys_equal(got, jcol.matmul_tflops(dim=64, iters=8))
    assert got["tflops"] > 0
    got = collectives.allreduce_bandwidth(size_mb=0.1, iters=4,
                                          devices=["cpu"])
    want = jcol.allreduce_bandwidth(size_mb=0.1, iters=4,
                                    devices=jax.devices()[:1])
    _keys_equal(got, want)
    assert got["devices"] == want["devices"] == 1
    assert got["size_mb"] == want["size_mb"]


def test_allreduce_refuses_several_cpu_devices():
    with pytest.raises(ValueError, match="NCCL"):
        collectives.allreduce_bandwidth(size_mb=0.1, devices=["cpu", "cpu"])


def test_probes_default_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collectives.matmul_tflops(dim=8, iters=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collectives.allreduce_bandwidth(size_mb=0.1)


def test_dispatch_probe_counts_equal_jax_at_its_widths():
    """The same tiny drains through the per-step and fused engines at
    the reference's widths (d_model 128 over 4 heads): the dispatch
    counter's launches and readbacks a token are the JAX engine's."""
    got = collectives.dispatch_probe(d_model=128, device="cpu")
    want = jcol.dispatch_probe()
    _keys_equal(got, want)
    for k in ("rtt_samples", "chain_steps",
              "per_step_dispatches_per_token",
              "fused_dispatches_per_token", "per_step_readbacks",
              "fused_readbacks", "dispatch_amortization_x", "valid"):
        assert got[k] == want[k], k
    assert got["valid"] is True


def test_dispatch_probe_default_widths_are_the_cards():
    """Its defaults are the JAX probe's, parameter by parameter (d_model
    128 over 4 heads: heads of 32, which the card's kernels take), and
    its counts at those defaults are the reference's."""
    import inspect
    want = inspect.signature(jcol.dispatch_probe).parameters
    have = inspect.signature(collectives.dispatch_probe).parameters
    assert {n: p.default for n, p in have.items() if n != "device"} == {
        n: p.default for n, p in want.items()}
    assert have["d_model"].default // have["heads"].default == 32
    got = collectives.dispatch_probe(device="cpu", rtt_samples=3)
    assert got["valid"] is True
    assert got["per_step_dispatches_per_token"] == 0.5
    assert got["fused_dispatches_per_token"] == 0.125
