"""Tensor-parallel serving in the port: ``ServingEngine(..., mesh=)`` on
int8 weights and on an MoE config, against the JAX package's
``ServingEngine`` on GSPMD-sharded weights (LoRA rows:
test_torch_tp_serving_lora.py).

Spawned gloo groups of ``MeshSpec(tp=2)`` and ``dp=2 x tp=2``
(tests/torch_dist.py ``tp_serving_worker``) drain five requests of mixed
prompt lengths over three slots: on ``shard_params(quantize_params(p))``
blocks (JAX: ``quantize_params`` of its sharded params, ROADMAP Queue C
55) and on a 4-expert top-2 MoE config (dense dispatch,
``_moe_mlp_replicated``).  Every rank finishes every request with the
same stream, and every stream equals JAX's token for token.  f32,
2 layers.
"""

import pytest

import torch_tp_serving as S

MODES = ("quant", "moe")
CASES = [(mode, mesh) for mode in MODES for mesh in sorted(S.MESHES)]


@pytest.fixture(scope="module")
def results():
    return S.run_modes(MODES)


@pytest.mark.parametrize("mode,mesh", CASES)
def test_streams_equal_jax_sharded_engine(results, mode, mesh):
    per_rank, want = results[(mode, mesh)]
    got = S.check_ranks_equal(per_rank)
    S.check_against(got, want)
    for r in per_rank:
        assert r["kv_heads"] == S.FIELDS["n_kv_heads"] // 2
