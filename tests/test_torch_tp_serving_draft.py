"""Tensor-parallel serving in the port: ``ServingEngine(..., mesh=)``
with a draft model, against the JAX package's ``ServingEngine`` on
GSPMD-sharded weights.

Spawned gloo groups of ``MeshSpec(tp=2)`` and ``dp=2 x tp=2``
(tests/torch_dist.py ``tp_serving_worker``) drain five requests of mixed
prompt lengths over three slots on their ``shard_params`` blocks of the
target and of its draft (the target's first layer; its blocks and its
cache cut by the same mesh, as GSPMD splits ``shard_params(draft)``),
step by step (``draft_propose_rows`` and ``decode_window_rows`` under
the mesh) and in fused blocks (``decode_spec_fused_rows``, step by step
under the mesh).  Every rank finishes every request with the same
stream, every stream equals JAX's sharded engine's token for token,
and the fused drain equals the step drain.  f32, 2 layers.
"""

import pytest

import torch_tp_serving as S

MODES = ("draft", "draft_fused")
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
        assert r["kv_heads"] == r["draft_kv_heads"] == (
            S.FIELDS["n_kv_heads"] // 2)
        assert r["stats"]["speculative_windows_total"] >= 1


@pytest.mark.parametrize("mesh", sorted(S.MESHES))
def test_fused_drain_equals_step_drain(results, mesh):
    step = S.check_ranks_equal(results[("draft", mesh)][0])
    got = S.check_ranks_equal(results[("draft_fused", mesh)][0])
    S.check_against(got, step)
    for r in results[("draft_fused", mesh)][0]:
        assert r["by_label"].get("decode_spec_fused_rows", 0) >= 1


@pytest.mark.parametrize("mesh", sorted(S.MESHES))
def test_draft_model_drafts_under_the_mesh(results, mesh):
    """The draft model proposes through ``draft_propose_rows`` step by
    step, and its proposals are accepted."""
    for r in results[("draft", mesh)][0]:
        assert r["by_label"].get("draft_propose_rows", 0) >= 1
        assert r["stats"]["speculative_accepted_total"] >= 1
