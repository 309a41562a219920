"""Tensor-parallel decode on int8 weights in the port
(k8s_dra_driver_tpu_torch/models/decode.py's ``mesh=``), against the JAX
package's decode on GSPMD-sharded weights (the int8 KV cache and the
paged pool: test_torch_tp_decode_a0.py; LoRA:
test_torch_tp_decode_a0_lora.py; MoE: test_torch_tp_decode_a0_moe.py;
the shared half: tests/torch_a0.py).  f32, 2 layers.

The port's ``shard_params(quantize_params(p))`` against JAX's
``quantize_params(shard_params(p))`` (the JAX order the other way round
raises), through K7's entries on each rank's shards, at tp=2 and dp=2 x
tp=2: the prompt's logits and those of steps fed the same tokens within
FWD_TOL of their largest magnitude on every rank; the greedy tokens
equal JAX's single-device run exactly; every rank's ``gather_params`` of
its int8 blocks is the whole ``quantize_params`` output.  Unit tests cut
every ``QTensor`` leaf on each coordinate of an ep=2 x tp=2 mesh.
"""

import numpy as np
import pytest
import torch

import torch_a0
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.models.quant import QTensor, quantize_params
from k8s_dra_driver_tpu_torch.parallel import mesh as tmesh
from torch_a0 import MOE, fake_mesh, small

# name: (world, spec, variant, config fields)
CASES = {
    "quant_tp2": (2, dict(tp=2), "quant", dict()),
    "quant_dp2_tp2": (4, dict(dp=2, tp=2), "quant", dict()),
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


@pytest.mark.parametrize("name", ["quant_dp2_tp2", "quant_tp2"])
def test_gather_params_inverts_the_qtensor_cut(results, name):
    """Every rank's ``gather_params`` of its int8 blocks is the whole
    ``quantize_params`` of the case's weights, bit for bit."""
    _, params = torch_a0.case_params(CASES, name)
    cfg = small(**CASES[name][3])
    whole = quantize_params(params_from_jax(params, device="cpu"), cfg)
    want = {"embed": whole["embed"], "unembed": whole["unembed"]}
    for li, layer in enumerate(whole["layers"]):
        for key, w in layer.items():
            if isinstance(w, QTensor):
                want[f"layers/{li}/{key}"] = w
    for r in results[name][0]:
        assert sorted(r["gathered"]) == sorted(want)
        for leaf, (q, s) in r["gathered"].items():
            np.testing.assert_array_equal(q, want[leaf].q.numpy())
            np.testing.assert_array_equal(s, want[leaf].scale.numpy())


# --------------------------------------------------------------------------
# Unit tests: the QTensor cut on a mesh's coordinates (no process group)
# --------------------------------------------------------------------------

#: leaf -> (config fields, whole scale shape, a rank's (q, scale) shapes
#: at ep=2 x tp=2): wq/wk/wv scale [1, H/tp, K]; wo [1, 1, d] whole;
#: embed [V, 1] whole beside q [V, d/tp]; unembed [1, V] whole beside q
#: [d/tp, V]; dense w_in [1, f/tp], w_out [1, d] whole; MoE w_in
#: [E/ep, 1, f/tp], w_out [E/ep, 1, d]
QCUTS = {
    "embed": ({}, (80, 1), ((80, 16), (80, 1))),
    "unembed": ({}, (1, 80), ((16, 80), (1, 80))),
    "wq": ({}, (1, 4, 8), ((32, 2, 8), (1, 2, 8))),
    "wk": ({}, (1, 2, 8), ((32, 1, 8), (1, 1, 8))),
    "wv": ({}, (1, 2, 8), ((32, 1, 8), (1, 1, 8))),
    "wo": ({}, (1, 1, 32), ((2, 8, 32), (1, 1, 32))),
    "w_in": ({}, (1, 64), ((32, 32), (1, 32))),
    "w_out": ({}, (1, 32), ((32, 32), (1, 32))),
    "moe_w_in": (MOE, (4, 1, 64), ((2, 32, 32), (2, 1, 32))),
    "moe_w_out": (MOE, (4, 1, 32), ((2, 32, 32), (2, 1, 32))),
}


@pytest.mark.parametrize("leaf", sorted(QCUTS))
def test_qtensor_cut_of_every_leaf(leaf):
    """Each rank of ep=2 x tp=2 gets ``q`` cut by the leaf's spec and
    ``scale`` cut by it where the scale is not 1: the blocks of the
    whole ``quantize_params`` output, values included, as fresh
    contiguous tensors."""
    kw, whole_scale, shapes = QCUTS[leaf]
    cfg = small(**kw)
    key = leaf.removeprefix("moe_")
    whole = quantize_params(tt.init_params(cfg, device="cpu"), cfg)
    w = whole[key] if key in whole else whole["layers"][1][key]
    assert tuple(w.scale.shape) == whole_scale
    spec = tt.param_specs(cfg)
    spec = spec[key] if key in spec else spec["layers"][1][key]
    for rank in range(4):
        mesh = fake_mesh(rank, ep=2, tp=2)
        cut = tt.shard_params(whole, cfg, mesh)
        got = cut[key] if key in cut else cut["layers"][1][key]
        assert isinstance(got, QTensor)
        assert (tuple(got.q.shape), tuple(got.scale.shape)) == shapes
        bounds = tmesh.spec_block(w.q.shape, spec, mesh.spec.axis_sizes(),
                                  mesh.coords)
        q, s = w.q, w.scale
        for dim, (lo, hi) in enumerate(bounds):
            q = q.narrow(dim, lo, hi - lo)
            if s.shape[dim] != 1:
                s = s.narrow(dim, lo, hi - lo)
        assert torch.equal(got.q, q) and torch.equal(got.scale, s)
        assert got.q.is_contiguous() and got.scale.is_contiguous()
