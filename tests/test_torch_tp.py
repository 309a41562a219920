"""Tensor parallelism in the port (k8s_dra_driver_tpu_torch/models/
transformer.py over parallel/mesh.py's tp axis) against the JAX
package's GSPMD layout on the same ``MeshSpec``.

Spawned gloo groups of 2 and 4 ranks (tests/torch_dist.py) run the
port, each rank on its blocks of JAX's weights (``shard_params``, the
rule table of models/layouts.py); JAX runs in this process on the
virtual 8-device CPU mesh.  f32 throughout.

- ``forward`` over ``tp=2`` (MHA and GQA), ``dp=2 x tp=2`` and
  ``sp=2 x tp=2`` (ring and Ulysses): logits at FWD_TOL (JAX's own
  2e-4, tests/test_workloads.py).
- Two ``make_train_step`` steps over ``tp=2`` (GQA), ``dp=2 x tp=2``
  and ``sp=2 x tp=2`` (ring, packed segments): losses at LOSS_RTOL,
  every leaf's summed gradient of the first step, gathered from the
  ranks' blocks, at GRAD_TOL of its largest entry, and every updated
  leaf at PARAM_ATOL (NOISE_ATOL where the first gradient is within
  GRAD_TOL of zero, AdamW's noise band).
- A config whose heads do not divide by tp is refused in JAX's words.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.parallel import mesh as tmesh

FWD_TOL = 2e-4
LOSS_RTOL = 1e-4
#: gradients, relative to each leaf's largest entry: the partial sums
#: and the f32 all-reduces reorder f32 sums through up to four layers
#: (a leaf summed over a wrong axis is off by a whole factor)
GRAD_TOL = 5e-4
#: parameters after two AdamW steps (tests/test_torch_parallel.py) ...
PARAM_ATOL = 1e-4
#: ... except where the first gradient is within GRAD_TOL of zero: its
#: sign is then rounding noise, and AdamW's first update
#: lr g / (|g| + eps) is a whole step of lr either way, so those entries
#: are held to two steps' worth a step
NOISE_ATOL = 2 * 3e-4 * 2

BASE = dict(vocab=96, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=12, d_ff=96, max_seq=64)

# name: (world, spec, config fields, with segments)
FORWARD = {
    "tp2_mha": (2, dict(tp=2), dict(n_kv_heads=0), False),
    "tp2_gqa": (2, dict(tp=2), dict(), True),
    "dp2_tp2": (4, dict(dp=2, tp=2), dict(), False),
    "sp2_tp2_ring": (4, dict(sp=2, tp=2), dict(attention_window=5), True),
    "sp2_tp2_ulysses": (4, dict(sp=2, tp=2),
                        dict(n_kv_heads=0, seq_parallel="ulysses"), False),
}
TRAIN = {
    "tp2_gqa": (2, dict(tp=2), dict(), False),
    "dp2_tp2": (4, dict(dp=2, tp=2), dict(), False),
    "sp2_tp2_ring_segments": (4, dict(sp=2, tp=2), dict(), True),
}


def configs(**kw):
    fields = dict(BASE, **kw)
    return (jt.TransformerConfig(dtype=jnp.float32, **fields),
            dict(dtype=torch.float32, **fields))


def tokens(seed, b=4, t=16):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], (b, t)).astype(np.int32)


def segments(seed, b=4, t=16):
    return np.cumsum(np.random.default_rng(seed).integers(0, 5, (b, t))
                     == 0, axis=1).astype(np.int32)


def rel(got, want) -> float:
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One spawned group per world size runs its forward and train
    cases; JAX computes its references here while the groups run (its
    initial train states first: the groups start from them)."""
    import jax
    fwd, train = {}, {}
    for i, (name, (world, spec, kw, with_seg)) in enumerate(
            sorted(FORWARD.items())):
        jcfg, tcfg = configs(**kw)
        params = jax.tree.map(np.array, jt.init_params(
            jcfg, jax.random.PRNGKey(1)))
        fwd[name] = (dict(kind="forward", spec=spec, cfg=tcfg,
                          params=params, tokens=tokens(i),
                          seg=segments(i + 50) if with_seg else None),
                     jcfg)
    for i, (name, (world, spec, kw, with_seg)) in enumerate(
            sorted(TRAIN.items())):
        jcfg, tcfg = configs(**kw)
        batches = [tokens(10 * i + j) for j in range(2)]
        segs = ([segments(10 * i + 20 + j) for j in range(2)]
                if with_seg else None)
        init, finish = torch_dist.jax_train(jcfg, world, spec, batches,
                                            segs=segs)
        train[name] = (dict(kind="train", spec=spec, cfg=tcfg,
                            params=init, tokens=batches, seg=segs), finish)
    groups = {}
    for world in (2, 4):
        f_names = sorted(n for n in FORWARD if FORWARD[n][0] == world)
        t_names = sorted(n for n in TRAIN if TRAIN[n][0] == world)
        cases = [fwd[n][0] for n in f_names] + [train[n][0] for n in t_names]
        groups[world] = (f_names, t_names, torch_dist.Group(
            torch_dist.model_worker, world, (cases,),
            tmp_path_factory.mktemp(f"tp{world}")))
    train_want = {name: finish() for name, (_, finish) in train.items()}
    fwd_want = {name: torch_dist.jax_forward(
        jcfg, c["params"], c["tokens"], FORWARD[name][0], c["spec"],
        c["seg"]) for name, (c, jcfg) in fwd.items()}
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
def test_tp_forward_matches_jax(results, name):
    got, want = results["forward"][name]
    assert got.shape == want.shape == (4, 16, BASE["vocab"])
    assert rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_tp_train_steps_match_jax_leaf_by_leaf(results, name):
    """Every rank reports JAX's losses; the first step's gradient of
    every leaf, gathered from the ranks' blocks, is JAX's, and so is
    every leaf after the two steps."""
    per_rank, want = results["train"][name]
    for r in per_rank:
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        assert sorted(r["grads"]) == sorted(want["grads"])
        for key, g in r["grads"].items():
            assert rel(g, want["grads"][key]) <= GRAD_TOL, key
        for key, value in r["params"].items():
            assert_params_close(value, want["final"][key],
                                want["grads"][key], key)


def assert_params_close(got, want, grad, key):
    band = np.abs(grad) <= GRAD_TOL * np.abs(grad).max()
    diff = np.abs(got - want)
    assert diff[~band].max(initial=0.0) <= PARAM_ATOL, key
    assert diff[band].max(initial=0.0) <= NOISE_ATOL, key


def test_heads_that_do_not_divide_by_tp_are_refused_in_jax_words():
    cfg = tt.TransformerConfig(vocab=32, d_model=16, n_layers=1, n_heads=3,
                               d_head=8, d_ff=32, dtype=torch.float32)
    spec = tmesh.MeshSpec(tp=2)
    mesh = types.SimpleNamespace(spec=spec,
                                 coords=tmesh.mesh_coords(0, spec))
    with pytest.raises(ValueError, match="should be divisible by 2, but "
                                         "it is equal to 3"):
        tt.shard_params(tt.init_params(cfg, device="cpu"), cfg, mesh)
