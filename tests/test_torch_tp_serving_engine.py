"""Tensor-parallel serving in the port: ``ServingEngine(..., mesh=)``
(k8s_dra_driver_tpu_torch/models/serving.py) step by step, in fused
blocks and with chunked fills, against the JAX package's
``ServingEngine`` on GSPMD-sharded weights (the paged pool and the
prefix cache: test_torch_tp_serving_paged.py).

Spawned gloo groups of ``MeshSpec(tp=2)`` and ``dp=2 x tp=2``
(tests/torch_dist.py ``tp_serving_worker``) each drain five requests of
mixed prompt lengths over three slots, on their ``shard_params``
blocks: step by step, in fused blocks of 4 (``chain_steps=4``: under a
mesh the step-by-step ``decode_fused_rows``, no CUDA graph) and with
4-token prefill chunks.
JAX drains the same requests on ``jt.shard_params`` over the virtual
8-device CPU mesh (tests/torch_tp_serving.py).  Every rank finishes
every request with the same stream, and every stream equals JAX's token
for token; the fused drain equals the step drain.  f32, 2 layers.
"""

import pytest

import torch_tp_serving as S

MODES = ("step", "chain4", "chunk")
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
        assert not r["graphs"]


@pytest.mark.parametrize("mesh", sorted(S.MESHES))
def test_fused_drain_equals_step_drain(results, mesh):
    step = S.check_ranks_equal(results[("step", mesh)][0])
    fused = S.check_ranks_equal(results[("chain4", mesh)][0])
    S.check_against(fused, step)
    for r in results[("chain4", mesh)][0]:
        assert r["by_label"].get("decode_fused_rows", 0) >= 1
        assert "decode_step_rows" not in r["by_label"]
