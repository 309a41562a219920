"""Tensor-parallel serving in the port: ``ServingEngine(..., mesh=)``
with the n-gram draft source and with sampled rows, against the JAX
package's ``ServingEngine`` on GSPMD-sharded weights (a draft model:
test_torch_tp_serving_draft.py).

Spawned gloo groups of ``MeshSpec(tp=2)`` and ``dp=2 x tp=2``
(tests/torch_dist.py ``tp_serving_worker``) drain five requests of mixed
prompt lengths over three slots on their ``shard_params`` blocks: the
n-gram draft source step by step and in fused blocks
(``decode_spec_fused_rows``, step by step under the mesh), and two
sampled requests beside three greedy ones (``top_k=5``), step by step
and fused.  Every rank finishes every request with the same stream;
every greedy stream equals JAX's sharded engine's token for token;
sampled streams, which draw from ``torch.Generator``s and cannot match
``jax.random``, equal the port's single-process engine on the whole
weights; each fused drain equals its step drain.  f32, 2 layers.
"""

import pytest

import torch_tp_serving as S

MODES = ("ngram", "ngram_fused", "sampled", "sampled_fused")
CASES = [(mode, mesh) for mode in MODES for mesh in sorted(S.MESHES)]
#: each fused mode's step twin
STEP_OF = {"ngram_fused": "ngram", "sampled_fused": "sampled"}


@pytest.fixture(scope="module")
def results():
    return S.run_modes(MODES)


@pytest.fixture(scope="module")
def single_process():
    """The port's single-process sampled drains: the sampled rows'
    reference."""
    return {mode: S.port_streams(mode) for mode in ("sampled",
                                                    "sampled_fused")}


@pytest.mark.parametrize("mode,mesh", CASES)
def test_streams_equal_jax_sharded_engine(results, single_process, mode,
                                          mesh):
    per_rank, want = results[(mode, mesh)]
    got = S.check_ranks_equal(per_rank)
    S.check_against(got, want, S.greedy_uids(mode))
    if mode in single_process:
        S.check_against(got, single_process[mode])
    for r in per_rank:
        assert r["kv_heads"] == S.FIELDS["n_kv_heads"] // 2
        if mode.startswith("ngram"):
            assert r["stats"]["speculative_windows_total"] >= 1


@pytest.mark.parametrize("fused", sorted(STEP_OF))
@pytest.mark.parametrize("mesh", sorted(S.MESHES))
def test_fused_drain_equals_step_drain(results, fused, mesh):
    step = S.check_ranks_equal(results[(STEP_OF[fused], mesh)][0])
    got = S.check_ranks_equal(results[(fused, mesh)][0])
    S.check_against(got, step)
    label = ("decode_fused_rows" if fused.startswith("sampled")
             else "decode_spec_fused_rows")
    for r in results[(fused, mesh)][0]:
        assert r["by_label"].get(label, 0) >= 1
