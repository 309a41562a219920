"""The port's serving-path probes (k8s_dra_driver_tpu_torch/ops/
collectives.py ``decode_probe`` and ``serving_probe``) on the CPU
against the JAX package's, at a tiny config.

``decode_probe`` times ``greedy_generate`` (bf16 and int8 weights, the
int8 cache) and ``serving_probe`` drains ``ServingEngine`` (step by step
and in fused blocks with a prefix cache): the same keys as the JAX
probes, the same counted quantities (parameters, streamed bytes a
token, tokens generated, prefix hits), and valid readings.  CPU times
are not device times; the card runs these probes in ``chip_smoke.py``.
"""

import pytest

from k8s_dra_driver_tpu.ops import collectives as jcol
from k8s_dra_driver_tpu_torch.ops import collectives

TINY = dict(n_layers=1, d_model=64, heads=4, kv_heads=2, d_ff=128)


def test_decode_probe_equals_jax_in_what_it_counts():
    kw = dict(batch=2, prompt_len=8, n_tokens=4, max_seq=16, reps=1,
              **TINY)
    want = jcol.decode_probe(**kw)
    for int8, kv_int8 in ((False, False), (True, True)):
        got = collectives.decode_probe(int8=int8, kv_int8=kv_int8,
                                       device="cpu", **kw)
        assert set(got) == set(want)
        counted = ("batch", "layers", "d_model", "heads", "kv_heads",
                   "params_m", "prompt_len", "n_tokens")
        assert {k: got[k] for k in counted} == {k: want[k] for k in counted}
        assert (got["int8"], got["kv_int8"]) == (int8, kv_int8)
        assert got["valid"] is True and got["ms_per_token"] > 0
        if not int8:
            assert got["streamed_mb_per_token"] == \
                want["streamed_mb_per_token"]
        else:                       # int8 weights and cache: half the bytes
            assert got["streamed_mb_per_token"] == pytest.approx(
                want["streamed_mb_per_token"] / 2, abs=0.1)


def test_serving_probe_equals_jax_in_what_it_counts():
    kw = dict(slots=2, n_requests=4, prompt_len=16, max_new=4, max_seq=32,
              chain_steps=3, prefix_cache=2, shared_prefix=8, **TINY)
    want = jcol.serving_probe(**kw)
    got = collectives.serving_probe(device="cpu", **kw)
    assert set(got) == set(want)
    for k in ("slots", "requests", "generated_tokens", "chain_steps",
              "shared_prefix", "prefix_hits", "prefix_tokens_reused",
              "host_dispatches", "host_readbacks", "dispatches_per_token",
              "valid"):
        assert got[k] == want[k], k
    plain = collectives.serving_probe(device="cpu", slots=2, n_requests=4,
                                      prompt_len=16, max_new=4, max_seq=32,
                                      **TINY)
    assert set(plain) == set(want) - {"chain_steps", "tokens_per_s",
                                      "shared_prefix", "prefix_hits",
                                      "prefix_tokens_reused"}
    assert plain["valid"] is True and plain["generated_tokens"] == 16
