"""LoRA under tensor-parallel decode in the port
(k8s_dra_driver_tpu_torch/models/decode.py's ``mesh=``, the pool's cut
``serving_lora/pool.py`` ``shard_lora_buffers``), against the JAX
package's ``decode_step_rows`` on GSPMD-sharded weights with the pool's
whole buffers (the shared half: tests/torch_a0.py).  f32, 2 layers.

Rows mixing slots 0-3 (three adapters of rank 4 and the null slot) on a
rank's cut of the buffers, at tp=2 and dp=2 x tp=2: the prompt's logits
and those of steps fed the same tokens within FWD_TOL of their largest
magnitude on every rank; the greedy tokens equal JAX's single-device
run exactly.  Unit tests: the buffers' cut, the JAX pool's layout.
"""

import pytest
import torch

import torch_a0
import torch_dist
from k8s_dra_driver_tpu.serving_lora import pool as jpool
from k8s_dra_driver_tpu_torch.serving_lora.pool import shard_lora_buffers
from torch_a0 import LORA, fake_mesh, small

# name: (world, spec, variant, config fields)
CASES = {
    "lora_tp2": (2, dict(tp=2), "lora", dict()),
    "lora_dp2_tp2": (4, dict(dp=2, tp=2), "lora", dict()),
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

def test_lora_buffer_cut_follows_lora_rules():
    """wq's B and wo's A are cut on their head axis (one dim right of
    ``lora_rules``' spec, for the slot axis), wq's A and wo's B stay
    whole; the cut owns its tensors."""
    cfg = small()
    pool, slots = torch_dist.a0_lora(cfg, LORA)
    assert slots == [1, 2, 3]
    whole = pool.buffers
    for rank in range(2):
        cut = shard_lora_buffers(whole, fake_mesh(rank, tp=2))
        assert len(cut) == cfg.n_layers
        for layer, (aq, bq, ao, bo) in zip(cut, whole):
            lo, hi = 2 * rank, 2 * rank + 2
            assert torch.equal(layer[0], aq)
            assert torch.equal(layer[1], bq[:, :, lo:hi])
            assert torch.equal(layer[2], ao[:, lo:hi])
            assert torch.equal(layer[3], bo)
            for got, src in zip(layer, (aq, bq, ao, bo)):
                assert got.is_contiguous()
                assert got.data_ptr() != src.data_ptr()
    # without tp every leaf is whole
    for layer, src in zip(shard_lora_buffers(whole, fake_mesh(ep=2)), whole):
        assert all(torch.equal(a, b) for a, b in zip(layer, src))


def test_lora_buffers_have_the_jax_pool_layout():
    """The port's pool buffers, which JAX's decode takes whole in the
    group cases, have the JAX pool's leaf order and shapes."""
    jcfg, tcfg = torch_a0.configs()
    rows, buffers = torch_a0.lora_buffers(tcfg)
    assert list(rows) == LORA["rows"]
    shapes = [s for _, _, _, s in jpool.adapter_leaves(jcfg, LORA["rank"])]
    assert [a.shape[1:] for layer in buffers for a in layer] == shapes
