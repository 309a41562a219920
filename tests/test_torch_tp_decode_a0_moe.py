"""MoE configs under the port's decode on a mesh
(k8s_dra_driver_tpu_torch/models/decode.py's ``mesh=``: the dense
dispatch, ``transformer._moe_mlp_replicated``), against the JAX
package's decode on GSPMD-sharded weights (the shared half:
tests/torch_a0.py).  f32, 2 layers, 4 experts, top 2.

Over tp=2, over ep=2 alone (which failed with a shape error before: a
rank mixed its ``E/ep`` experts with gates over all ``E``) and over
ep=2 x tp=2: the prompt's logits and those of steps fed the same tokens
within FWD_TOL of their largest magnitude on every rank; the greedy
tokens equal JAX's single-device run exactly; every rank holds its
experts' and hidden units' blocks.
"""

import pytest

import torch_a0
from torch_a0 import MOE

# name: (world, spec, variant, config fields)
CASES = {
    "moe_tp2": (2, dict(tp=2), "moe", MOE),
    "moe_ep2": (2, dict(ep=2), "moe", MOE),
    "moe_ep2_tp2": (4, dict(ep=2, tp=2), "moe", MOE),
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
