"""Expert parallelism in the port (k8s_dra_driver_tpu_torch/models/
transformer.py ``_moe_mlp_sharded`` over parallel/mesh.py's ep axis)
against the JAX package on the same ``MeshSpec``: its
``_moe_mlp_gmm_sharded`` for gmm, GSPMD's partitioning for the dense and
capacity dispatches.

Spawned gloo groups of 2 and 4 ranks (tests/torch_dist.py) run the
port, each rank on its blocks of JAX's weights (experts split on ep,
their hidden units on tp); JAX runs in this process on the virtual
8-device CPU mesh.  f32 throughout; the tolerances are
tests/test_torch_tp.py's.

- ``forward``: gmm over ``ep=2``, ``ep=2 x tp=2`` and ``dp=2 x ep=2``;
  dense and capacity over ``ep=2`` (capacity at factor 0.5, so experts
  drop tokens); capacity over ``sp=2 x ep=2``, where each expert's
  budget still counts over the whole row.
- Two ``make_train_step`` steps (router aux losses on, so their global
  means are held too): gmm over ``ep=2`` and ``ep=2 x tp=2``, dense
  and capacity over ``ep=2``; losses, every leaf's first gradient and
  every updated leaf.
- The dropless parity of JAX's ``test_sharded_train_step_runs_dropless``:
  the sharded step's first loss equals the unsharded gmm loss.
- ``n_experts`` that does not divide by ep raises ``ValueError``
  ("divisible"), in the layout and in the dispatch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.parallel import mesh as tmesh
from test_torch_tp import (FWD_TOL, GRAD_TOL, LOSS_RTOL, assert_params_close,
                           rel)

BASE = dict(vocab=96, d_model=48, n_layers=2, n_heads=4, d_head=12,
            d_ff=96, n_experts=4, top_k=2, max_seq=64)
AUX = dict(aux_loss_weight=0.01, router_z_weight=0.001)

# name: (world, spec, config fields)
FORWARD = {
    "gmm_ep2": (2, dict(ep=2), dict(moe_dispatch="gmm")),
    "gmm_ep2_tp2": (4, dict(ep=2, tp=2), dict(moe_dispatch="gmm")),
    "gmm_dp2_ep2": (4, dict(dp=2, ep=2), dict(moe_dispatch="gmm")),
    "dense_ep2": (2, dict(ep=2), dict(moe_dispatch="dense")),
    "capacity_ep2": (2, dict(ep=2), dict(moe_dispatch="capacity",
                                         capacity_factor=0.5)),
    "capacity_sp2_ep2": (4, dict(sp=2, ep=2),
                         dict(moe_dispatch="capacity", capacity_factor=0.5)),
}
TRAIN = {
    "gmm_ep2": (2, dict(ep=2), dict(moe_dispatch="gmm", **AUX)),
    "gmm_ep2_tp2": (4, dict(ep=2, tp=2), dict(moe_dispatch="gmm", **AUX)),
    "dense_ep2": (2, dict(ep=2), dict(moe_dispatch="dense", **AUX)),
    "capacity_ep2": (2, dict(ep=2), dict(moe_dispatch="capacity",
                                         capacity_factor=0.5, **AUX)),
}


def configs(**kw):
    fields = dict(BASE, **kw)
    return (jt.TransformerConfig(dtype=jnp.float32, **fields),
            dict(dtype=torch.float32, **fields))


def tokens(seed, b=4, t=16):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    fwd, train = {}, {}
    for i, (name, (world, spec, kw)) in enumerate(sorted(FORWARD.items())):
        jcfg, tcfg = configs(**kw)
        params = jax.tree.map(np.array, jt.init_params(
            jcfg, jax.random.PRNGKey(1)))
        fwd[name] = (dict(kind="forward", spec=spec, cfg=tcfg,
                          params=params, tokens=tokens(i)), jcfg)
    for i, (name, (world, spec, kw)) in enumerate(sorted(TRAIN.items())):
        jcfg, tcfg = configs(**kw)
        batches = [tokens(10 * i + j) for j in range(2)]
        init, finish = torch_dist.jax_train(jcfg, world, spec, batches)
        train[name] = (dict(kind="train", spec=spec, cfg=tcfg,
                            params=init, tokens=batches), finish, jcfg)
    groups = {}
    for world in (2, 4):
        f_names = sorted(n for n in FORWARD if FORWARD[n][0] == world)
        t_names = sorted(n for n in TRAIN if TRAIN[n][0] == world)
        cases = [fwd[n][0] for n in f_names] + [train[n][0] for n in t_names]
        groups[world] = (f_names, t_names, torch_dist.Group(
            torch_dist.model_worker, world, (cases,),
            tmp_path_factory.mktemp(f"ep{world}")))
    train_want = {name: (c, finish(), jcfg)
                  for name, (c, finish, jcfg) in train.items()}
    fwd_want = {name: torch_dist.jax_forward(
        jcfg, c["params"], c["tokens"], FORWARD[name][0], c["spec"])
        for name, (c, jcfg) in fwd.items()}
    out = {"forward": {}, "train": {}}
    for world, (f_names, t_names, group) in groups.items():
        ranks = group.join()
        for i, name in enumerate(f_names):
            per_rank = [r[i] for r in ranks]
            out["forward"][name] = (torch_dist.unshard(
                [r["logits"] for r in per_rank],
                [r["coords"] for r in per_rank]), fwd_want[name])
        for j, name in enumerate(t_names):
            out["train"][name] = ([r[len(f_names) + j] for r in ranks],
                                  train_want[name])
    return out


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_ep_forward_matches_jax(results, name):
    got, want = results["forward"][name]
    assert got.shape == want.shape == (4, 16, BASE["vocab"])
    assert rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_ep_train_steps_match_jax_leaf_by_leaf(results, name):
    per_rank, (case, want, _) = results["train"][name]
    for r in per_rank:
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        assert sorted(r["grads"]) == sorted(want["grads"])
        for key, g in r["grads"].items():
            assert rel(g, want["grads"][key]) <= GRAD_TOL, key
        for key, value in r["params"].items():
            assert_params_close(value, want["final"][key],
                                want["grads"][key], key)


def test_sharded_gmm_step_is_dropless(results):
    """JAX's test_sharded_train_step_runs_dropless on the port: the
    ep x tp step's first loss is the unsharded gmm loss of the same
    weights and batch."""
    per_rank, (case, _, jcfg) = results["train"]["gmm_ep2_tp2"]
    want = float(jt.loss_fn(jax.tree.map(jnp.asarray, case["params"]),
                            jnp.asarray(case["tokens"][0]), jcfg))
    for r in per_rank:
        np.testing.assert_allclose(r["losses"][0], want, rtol=1e-4)


class FakeMesh:
    """Sizes and coordinates only: what the layout and the refusals read
    before any collective."""

    def __init__(self, **sizes):
        self.spec = tmesh.MeshSpec(**sizes)
        self.coords = tmesh.mesh_coords(0, self.spec)

    def size(self, axis):
        return self.spec.axis_sizes()[axis]

    def index(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("dispatch", ["gmm", "dense", "capacity"])
def test_experts_must_divide_by_ep(dispatch):
    cfg = tt.TransformerConfig(**dict(BASE, n_experts=3, dtype=torch.float32,
                                      moe_dispatch=dispatch))
    params = tt.init_params(cfg, device="cpu")
    mesh = FakeMesh(ep=2)
    with pytest.raises(ValueError, match="divisible"):
        tt.shard_params(params, cfg, mesh)
    with pytest.raises(ValueError, match="divisible"):
        tt.forward(params, torch.zeros((2, 8), dtype=torch.long),
                   dataclasses.replace(cfg), mesh=mesh)
