"""Tensor-parallel serving in the port: ``ServingEngine(..., mesh=)``
with LoRA rows, against the JAX package's ``ServingEngine`` on
GSPMD-sharded weights.

Spawned gloo groups of ``MeshSpec(tp=2)`` and ``dp=2 x tp=2``
(tests/torch_dist.py ``tp_serving_worker``) drain five requests of mixed
prompt lengths over three slots on their ``shard_params`` blocks, three
of them on two adapters of an ``AdapterPool`` whose buffers the engine
reads through views of this rank's cut (``shard_lora_buffers(...,
copy=False)``, taken once at the engine's start, before any load).
Every rank finishes every request with the same stream, every stream
equals JAX's token for token, and the adapters move their rows off the
base model's streams.  f32, 2 layers.  Unit test: the views show the
pool's loads.
"""

import numpy as np
import pytest
import torch

import torch_tp_serving as S
from k8s_dra_driver_tpu_torch.serving_lora.pool import (
    AdapterManifest, AdapterPool, make_adapter, shard_lora_buffers)
from torch_a0 import LORA, fake_mesh, small


@pytest.fixture(scope="module")
def results():
    return S.run_modes(("lora", "step"), jax_sharded=("lora",))


@pytest.mark.parametrize("mesh", sorted(S.MESHES))
def test_streams_equal_jax_sharded_engine(results, mesh):
    per_rank, want = results[("lora", mesh)]
    got = S.check_ranks_equal(per_rank)
    S.check_against(got, want)
    for r in per_rank:
        assert r["kv_heads"] == S.FIELDS["n_kv_heads"] // 2


@pytest.mark.parametrize("mesh", sorted(S.MESHES))
def test_adapters_move_their_rows(results, mesh):
    """The LoRA drain loaded both adapters, and its adapter rows part
    from the base model's streams (the drain of the same weights
    without adapters) while its base rows equal them."""
    lora = S.check_ranks_equal(results[("lora", mesh)][0])
    base = S.check_ranks_equal(results[("step", mesh)][0])
    for r in results[("lora", mesh)][0]:
        assert r["stats"]["adapter_cold_loads_total"] >= 2
    for i in range(len(S.MAX_NEW)):
        uid = f"r{i}"
        if i in S.ADAPTERS:
            assert not np.array_equal(lora[uid], base[uid]), uid
        else:
            np.testing.assert_array_equal(lora[uid], base[uid])


@pytest.mark.parametrize("rank", [0, 1])
def test_view_cut_shows_the_pools_loads(rank):
    """``shard_lora_buffers(..., copy=False)`` taken on an empty pool
    reads, after loads into it, what a fresh copying cut reads, through
    the pool's own storage."""
    cfg = small()
    pool = AdapterPool(cfg, LORA["rank"], len(LORA["names"]), device="cpu")
    mesh = fake_mesh(rank, tp=2)
    views = shard_lora_buffers(pool.buffers, mesh, copy=False)
    for name, seed in zip(LORA["names"], LORA["seeds"]):
        pool.register(AdapterManifest(
            name, LORA["rank"], source=make_adapter(cfg, LORA["rank"], seed)))
        pool.acquire(name)
    assert pool.cold_loads_total == len(LORA["names"])
    for layer, cut, src in zip(views, shard_lora_buffers(pool.buffers, mesh),
                               pool.buffers):
        for view, copy, buf in zip(layer, cut, src):
            assert torch.equal(view, copy)
            assert view.untyped_storage().data_ptr() == (
                buf.untyped_storage().data_ptr())
        assert layer[1].abs().sum() > 0
