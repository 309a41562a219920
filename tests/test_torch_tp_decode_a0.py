"""What tensor-parallel decode once refused, in the port
(k8s_dra_driver_tpu_torch/models/decode.py's ``mesh=``), against the JAX
package's decode on GSPMD-sharded weights: the int8 KV cache and the
paged pool through K2's entry.  LoRA: test_torch_tp_decode_a0_lora.py;
int8 weights: test_torch_tp_decode_a0_weights.py; MoE:
test_torch_tp_decode_a0_moe.py.

Spawned gloo groups of 2 and 4 ranks decode on their blocks of JAX's
weights; JAX runs the same variant in this process on
``jt.shard_params`` over the virtual 8-device CPU mesh and on one device
(tests/torch_a0.py).  f32, 2 layers:

- the int8 KV cache: a rank's k/v and their scales hold ``H_kv/tp``
  heads;
- the paged pool of ``H_kv/tp`` heads a rank, read through K2's entry
  (its plain version here) against JAX's dense-gather read, every token
  a ``paged_decode_step_rows`` step.

Each at tp=2 and at tp=4 (GQA): the prompt's logits and those of steps
fed the same tokens within FWD_TOL of their largest magnitude on every
rank; the greedy tokens equal JAX's single-device run of the same
variant exactly.  Unit tests: the cache's and the pool's local heads.
"""

import pytest
import torch

import torch_a0
from k8s_dra_driver_tpu_torch.models import decode as td
from torch_a0 import GQA4, fake_mesh, small

# name: (world, spec, variant, config fields)
CASES = {
    "int8kv_tp2": (2, dict(tp=2), "int8kv", dict(kv_cache_dtype="int8")),
    "int8kv_tp4": (4, dict(tp=4), "int8kv",
                   dict(kv_cache_dtype="int8", **GQA4)),
    "paged_tp2": (2, dict(tp=2), "paged", dict()),
    "paged_tp4": (4, dict(tp=4), "paged", GQA4),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return torch_a0.run_cases(CASES, tmp_path_factory)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a0_logits_match_jax_sharded_decode(results, name):
    torch_a0.check_logits(results[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_a0_greedy_tokens_equal_jax_single_device(results, name):
    torch_a0.check_tokens(results[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_a0_rank_holds_its_blocks(results, name):
    torch_a0.check_blocks(results[name], CASES[name])


# --------------------------------------------------------------------------
# Unit tests on a mesh's coordinates (no process group)
# --------------------------------------------------------------------------

def test_int8_cache_scales_hold_local_heads():
    cfg = small(kv_cache_dtype="int8", **GQA4)
    cache = td.init_cache(cfg, 2, device="cpu", mesh=fake_mesh(1, tp=4))
    assert cache.k[0].shape == (2, 32, 1, 8)
    assert cache.k[0].dtype == torch.int8
    assert cache.k_scale[0].shape == cache.v_scale[0].shape == (2, 32, 1, 1)


def test_paged_pool_holds_local_heads():
    cfg = small(**GQA4)
    pool = td.init_paged_pool(cfg, 5, 4, device="cpu",
                              mesh=fake_mesh(3, tp=4))
    assert pool.k[0].shape == pool.v[0].shape == (5, 4, 1, 8)
    whole = td.init_paged_pool(cfg, 5, 4, device="cpu")
    assert whole.k[0].shape == (5, 4, 4, 8)


def test_paged_pool_refuses_pp_staged_under_tp():
    with pytest.raises(NotImplementedError, match="pp-staged.*ROADMAP Queue "
                                                  "A, item A3"):
        td.init_paged_pool(small(pp_stages=2), 5, 4, device="cpu",
                           mesh=fake_mesh(tp=2))
