"""Tensor-parallel serving in the port: ``ServingEngine(..., mesh=)``
(k8s_dra_driver_tpu_torch/models/serving.py) on the paged pool and with
the prefix cache, against the JAX package's ``ServingEngine`` on
GSPMD-sharded weights.

Spawned gloo groups of ``MeshSpec(tp=2)`` and ``dp=2 x tp=2``
(tests/torch_dist.py ``tp_serving_worker``) each drain five requests of
mixed prompt lengths over three slots, on their ``shard_params``
blocks: on a pool of 4-token blocks of each rank's KV heads
(``init_paged_pool(mesh=)``, ``paged_decode_step_rows(mesh=)``) and
with the contiguous prefix cache, whose entries hold each rank's heads.
JAX drains the same requests on ``jt.shard_params`` over the virtual
8-device CPU mesh (tests/torch_tp_serving.py).  Every rank finishes
every request with the same stream, and every stream equals JAX's token
for token.  f32, 2 layers.
"""

import pytest

import torch_tp_serving as S

MODES = ("paged", "prefix")
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


@pytest.mark.parametrize("mesh", sorted(S.MESHES))
def test_paged_and_prefix_modes_take_their_paths(results, mesh):
    """The paged drain steps through ``paged_decode_step_rows``; the
    prefix drain hits its store and fills hits through
    ``suffix_fill_adopt``."""
    for r in results[("paged", mesh)][0]:
        assert r["by_label"].get("paged_decode_step_rows", 0) >= 1
        assert "decode_step_rows" not in r["by_label"]
    for r in results[("prefix", mesh)][0]:
        assert r["stats"]["prefix_hits_total"] >= 1
        assert r["by_label"].get("suffix_fill_adopt", 0) >= 1
