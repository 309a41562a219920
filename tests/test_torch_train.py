"""Port training step (k8s_dra_driver_tpu_torch/models/transformer.py:
loss_fn, make_optimizer, make_train_step) against the JAX package's.

JAX's parameters, turned into numpy and moved over with
``params_from_jax``, are trained by both ``make_train_step``s on the
same numpy tokens: JAX's on a one-device CPU mesh, the port's on the
CPU, where attention is the dense oracle on both sides.  f32
throughout.  Losses agree to rtol 1e-5 and gradients (against
``jax.grad`` of ``loss_fn``) to 1e-4 of each tensor's largest entry:
summation order only; the embedding gradient, a scatter-add of
many rows that cancel, has small entries whose relative error in f32
is large on both sides, so the bound is set by each tensor's scale.
Parameters after
AdamW steps agree to atol 1e-4, a third of one step: Adam's first
updates are near lr * sign(g) with lr = 3e-4, so a gradient entry
within rounding of zero (|g| ~ eps = 1e-8) may take a visibly
different step in the two frameworks, while a missing or wrong
gradient moves a weight by a whole step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.parallel.mesh import MeshSpec, make_mesh
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax

BASE = dict(vocab=96, d_model=48, n_layers=2, n_heads=4, d_head=12,
            d_ff=96, max_seq=64)
LOSS_RTOL = 1e-5
GRAD_SCALE_TOL = 1e-4
PARAM_ATOL = 1e-4


def configs(**kw):
    fields = dict(BASE, **kw)
    return (jt.TransformerConfig(dtype=jnp.float32, **fields),
            tt.TransformerConfig(dtype=torch.float32, **fields))


def tokens(seed, b=4, t=16):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], (b, t)).astype(np.int32)


def segments(seed, b=4, t=16):
    return np.cumsum(np.random.default_rng(seed).integers(0, 5, (b, t))
                     == 0, axis=1).astype(np.int32)


def jax_state(jcfg, seed=0):
    """JAX (train_step, params, opt_state) on a one-device mesh, and the
    parameters as numpy (copied before any donating step)."""
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    step, init_state = jt.make_train_step(jcfg, mesh)
    params, opt = init_state(jax.random.PRNGKey(seed))
    return step, params, opt, jax.tree.map(np.array, params)


def port_state(tcfg, np_params):
    """The port's (train_step, params, opt_state) from JAX's numbers."""
    step, _ = tt.make_train_step(tcfg, device="cpu")
    params = params_from_jax(np_params, device="cpu")
    leaves = [t.requires_grad_() for _, t in tt.named_tensors(params)]
    return step, params, tt.make_optimizer()(leaves)


def assert_params_close(tparams, jparams, atol=PARAM_ATOL):
    want = dict(tt.named_tensors(jax.tree.map(np.asarray, jparams)))
    got = tt.named_tensors(tparams)
    assert sorted(want) == sorted(name for name, _ in got)
    for name, t in got:
        np.testing.assert_allclose(t.detach().numpy(), want[name],
                                   atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("with_segments", [False, True])
def test_loss_fn_and_grads_match_jax(with_segments):
    jcfg, tcfg = configs(n_kv_heads=2)
    _, _, _, np_params = jax_state(jcfg, seed=1)
    toks = tokens(2)
    seg = segments(3) if with_segments else None
    want, jgrads = jax.value_and_grad(jt.loss_fn)(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(toks), jcfg,
        segment_ids=None if seg is None else jnp.asarray(seg))
    params = params_from_jax(np_params, device="cpu")
    leaves = [t.requires_grad_() for _, t in tt.named_tensors(params)]
    got = tt.loss_fn(params, torch.from_numpy(toks), tcfg,
                     segment_ids=None if seg is None
                     else torch.from_numpy(seg))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    grads = torch.autograd.grad(got, leaves)
    jnamed = dict(tt.named_tensors(jax.tree.map(np.asarray, jgrads)))
    for (name, _), g in zip(tt.named_tensors(params), grads):
        scale = float(np.abs(jnamed[name]).max())
        np.testing.assert_allclose(g.numpy(), jnamed[name], rtol=0,
                                   atol=GRAD_SCALE_TOL * scale,
                                   err_msg=name)


def test_loss_fn_masks_every_cross_segment_target():
    """All-distinct segments leave no target in the mean: the loss is 0
    (the max(keep, 1) denominator), as in the JAX package."""
    _, tcfg = configs()
    params = tt.init_params(tcfg, device="cpu")
    toks = torch.from_numpy(tokens(4, b=2, t=8))
    seg = torch.arange(8, dtype=torch.int32).repeat(2, 1)
    assert float(tt.loss_fn(params, toks, tcfg, seg)) == 0.0


TRAIN_CASES = {
    "dense": (dict(), False),
    "gqa_window": (dict(n_kv_heads=2, attention_window=5), False),
    "mqa_segments": (dict(n_kv_heads=1), True),
}


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_steps_match_jax(name):
    """One and three AdamW steps from the same parameters and batches:
    losses and updated parameters against JAX's ``make_train_step``."""
    kw, with_segments = TRAIN_CASES[name]
    jcfg, tcfg = configs(**kw)
    jstep, jparams, jopt, np_params = jax_state(jcfg, seed=2)
    tstep, tparams, topt = port_state(tcfg, np_params)
    for i in range(3):
        toks = tokens(10 + i)
        seg = segments(20 + i) if with_segments else None
        jparams, jopt, jloss = jstep(
            jparams, jopt, jnp.asarray(toks),
            None if seg is None else jnp.asarray(seg))
        tparams, topt, tloss = tstep(tparams, topt, toks, seg)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=LOSS_RTOL, err_msg=f"step {i + 1}")
        if i in (0, 2):
            assert_params_close(tparams, jparams)


def test_remat_equals_no_remat():
    """``cfg.remat`` recomputes each layer in the backward
    (torch.utils.checkpoint): the same losses and parameters."""
    _, tcfg = configs(n_kv_heads=2)
    results = []
    for remat in (False, True):
        cfg = tt.TransformerConfig(**{**tcfg.__dict__, "remat": remat})
        step, init_state = tt.make_train_step(cfg, device="cpu")
        params, opt = init_state(torch.Generator().manual_seed(4))
        losses = []
        for i in range(2):
            params, opt, loss = step(params, opt, tokens(30 + i))
            losses.append(float(loss))
        results.append((losses, [t.detach().clone()
                                 for _, t in tt.named_tensors(params)]))
    (l0, p0), (l1, p1) = results
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for a, b in zip(p1, p0):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_init_state_binds_adamw_with_optax_defaults():
    _, tcfg = configs()
    _, init_state = tt.make_train_step(tcfg, device="cpu")
    params, opt = init_state(torch.Generator().manual_seed(0))
    leaves = tt.named_tensors(params)
    assert len(leaves) == 3 + 8 * tcfg.n_layers
    assert all(t.requires_grad and t.is_leaf for _, t in leaves)
    assert isinstance(opt, torch.optim.AdamW)
    (group,) = opt.param_groups
    assert all(a is b for a, (_, b) in zip(group["params"], leaves))
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 0.01)


def test_every_parameter_gets_a_gradient():
    _, tcfg = configs(n_kv_heads=2)
    step, init_state = tt.make_train_step(tcfg, device="cpu")
    params, opt = init_state(torch.Generator().manual_seed(1))
    before = [t.detach().clone() for _, t in tt.named_tensors(params)]
    params, opt, _ = step(params, opt, tokens(5))
    for (name, t), old in zip(tt.named_tensors(params), before):
        assert t.grad is not None and t.grad.abs().sum() > 0, name
        assert not torch.equal(t.detach(), old), name


def test_train_step_refuses_an_optimizer_of_other_params():
    _, tcfg = configs()
    step, init_state = tt.make_train_step(tcfg, device="cpu")
    params, _ = init_state(torch.Generator().manual_seed(0))
    _, other = init_state(torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="not bound"):
        step(params, other, tokens(0))


def test_make_train_step_refuses_moe_and_missing_card():
    """MoE configs train (tests/test_torch_moe.py holds them to JAX);
    a pipelined config without a mesh trains its layers in sequence,
    as JAX's ``mesh=None`` path runs them (its mesh path is held to JAX
    in tests/test_torch_pipeline.py): the same loss as the config
    without stages on the same weights."""
    jmoe, moe = configs(n_experts=4, moe_dispatch="gmm")
    _, init_state = tt.make_train_step(moe, device="cpu")
    params, opt = init_state(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params["layers"][0].items()} \
        == jt._layer_shapes(jmoe)
    assert len(opt.param_groups[0]["params"]) == 3 + 9 * moe.n_layers
    _, piped = configs(n_experts=4, pp_stages=2)
    _, flat = configs(n_experts=4)
    losses = []
    for cfg in (piped, flat):
        step, init = tt.make_train_step(cfg, device="cpu")
        p, o = init(torch.Generator().manual_seed(0))
        assert "layers" in p and len(p["layers"]) == cfg.n_layers
        losses.append(float(step(p, o, tokens(0))[2]))
    assert losses[0] == losses[1]
    if not torch.cuda.is_available():
        _, dense = configs()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.make_train_step(dense)
