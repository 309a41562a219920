"""Port sparse MoE (k8s_dra_driver_tpu_torch/models/transformer.py:
router, aux losses, dense / capacity / gmm dispatch, MoE training)
against the JAX package's.

JAX's parameters, turned into numpy and moved over with
``params_from_jax``, and numpy activations go through both packages on
the CPU, f32 throughout; the JAX gmm runs its Pallas kernels in
interpret mode, the port's its plain versions.  Tolerances: router
gates, aux losses and MoE outputs 1e-5 (f32, summation order only;
seeded random inputs have no ties at the k-th gate, so both packages
pick the same experts, and the order of the k picks only changes the
f32 order of the combine); logits 1e-4 as ``test_torch_transformer``;
losses, gradients and parameters after AdamW steps as
``test_torch_train`` (rtol 1e-5, 1e-4 of each gradient's largest
entry, atol 1e-4 = a third of one step).
"""

import dataclasses

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
            d_ff=96, max_seq=64, n_experts=4, top_k=2)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_SCALE_TOL = 1e-4
PARAM_ATOL = 1e-4
DISPATCHES = ("dense", "capacity", "gmm")


def configs(**kw):
    fields = dict(BASE, **kw)
    return (jt.TransformerConfig(dtype=jnp.float32, **fields),
            tt.TransformerConfig(dtype=torch.float32, **fields))


def jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jt.init_params(cfg, jax.random.PRNGKey(seed)))


def tokens(seed, b=2, t=16):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], (b, t)).astype(np.int32)


def layer_inputs(seed, b=2, t=16):
    """A layer's MoE weights (JAX init) and normalized activations."""
    layer = jax_params(configs()[0], seed)["layers"][0]
    x = np.random.default_rng(seed + 100).standard_normal(
        (b, t, BASE["d_model"])).astype(np.float32)
    return layer, x


def both_layers(layer):
    return ({k: jnp.asarray(v) for k, v in layer.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in layer.items()})


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_router_gates_equal_jax(top_k):
    jcfg, tcfg = configs(top_k=top_k)
    layer, x = layer_inputs(1)
    jl, tl = both_layers(layer)
    want = jt._router_gates(jnp.asarray(x), jl, jcfg)
    got = tt._router_gates(torch.from_numpy(x), tl, tcfg)
    for w, g, name in zip(want, got, ("gates", "probs", "logits")):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    selected = (got[0] > 0).sum(-1)
    assert torch.all(selected == top_k)


def test_moe_aux_equals_jax():
    jcfg, tcfg = configs()
    layer, x = layer_inputs(2)
    jl, tl = both_layers(layer)
    want = jt._moe_aux(*jt._router_gates(jnp.asarray(x), jl, jcfg), jcfg)
    got = tt._moe_aux(*tt._router_gates(torch.from_numpy(x), tl, tcfg),
                      tcfg)
    for w, g in zip(want, got):
        assert g.ndim == 0 and g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), **TOL)


@pytest.mark.parametrize("factor,t", [(1.25, 16), (0.5, 16), (1.0, 7),
                                      (4.0, 3)])
def test_moe_capacity_equals_jax(factor, t):
    jcfg, tcfg = configs(capacity_factor=factor)
    assert tt._moe_capacity(tcfg, t) == jt._moe_capacity(jcfg, t)


MLP_CASES = {
    "dense": dict(moe_dispatch="dense"),
    "capacity_1.25": dict(moe_dispatch="capacity", capacity_factor=1.25),
    "capacity_0.5": dict(moe_dispatch="capacity", capacity_factor=0.5),
    "gmm": dict(moe_dispatch="gmm"),
    "gmm_top1": dict(moe_dispatch="gmm", top_k=1),
}


@pytest.mark.parametrize("name", sorted(MLP_CASES))
def test_moe_mlp_equals_jax(name):
    jcfg, tcfg = configs(**MLP_CASES[name])
    layer, x = layer_inputs(3)
    jl, tl = both_layers(layer)
    want, (jload, jz) = jt._moe_mlp(jnp.asarray(x), jl, jcfg,
                                    with_aux=True)
    got, (tload, tz) = tt._moe_mlp(torch.from_numpy(x), tl, tcfg,
                                   with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose([float(tload), float(tz)],
                               [float(jload), float(jz)], **TOL)


def test_tight_capacity_drops_the_tokens_jax_drops():
    """At capacity factor 0.5 some routed (token, expert) pairs fall
    out of the budget: the port keeps exactly the pairs JAX keeps (its
    one-hot is zero past the budget where ``F.one_hot`` would raise),
    and its output differs from dense dispatch as JAX's does."""
    jcfg, tcfg = configs(moe_dispatch="capacity", capacity_factor=0.5)
    layer, x = layer_inputs(4)
    jl, tl = both_layers(layer)
    gates = tt._router_gates(torch.from_numpy(x), tl, tcfg)[0]
    cap = tt._moe_capacity(tcfg, x.shape[1])
    pos = torch.cumsum((gates > 0).to(torch.int32), dim=1) - 1
    dropped = int(((gates > 0) & (pos >= cap)).sum())
    assert dropped > 0
    got = tt._moe_mlp(torch.from_numpy(x), tl, tcfg)
    want = jt._moe_mlp(jnp.asarray(x), jl, jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = tt._moe_mlp(torch.from_numpy(x), tl,
                        dataclasses.replace(tcfg, moe_dispatch="dense"))
    jdense = jt._moe_mlp(jnp.asarray(x), jl,
                         dataclasses.replace(jcfg, moe_dispatch="dense"))
    np.testing.assert_allclose((got - dense).abs().max().item(),
                               float(jnp.abs(want - jdense).max()),
                               rtol=1e-4)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_forward_with_aux_equals_jax(dispatch):
    jcfg, tcfg = configs(moe_dispatch=dispatch, n_kv_heads=2)
    jp = jax_params(jcfg, seed=5)
    toks = tokens(6)
    want, jaux = jt.forward(jp, jnp.asarray(toks), jcfg, return_aux=True)
    got, taux = tt.forward(params_from_jax(jp, device="cpu"),
                           torch.from_numpy(toks).long(), tcfg,
                           return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert set(taux) == {"load_balance", "router_z"}
    for key in taux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   **TOL)


def test_dense_config_aux_is_zero():
    _, tcfg = configs(n_experts=0)
    params = tt.init_params(tcfg, device="cpu")
    logits, aux = tt.forward(params, torch.from_numpy(tokens(7)).long(),
                             tcfg, return_aux=True)
    assert logits.shape == (2, 16, BASE["vocab"])
    assert float(aux["load_balance"]) == 0.0 == float(aux["router_z"])


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_loss_and_grads_with_aux_weights_equal_jax(dispatch):
    jcfg, tcfg = configs(moe_dispatch=dispatch, aux_loss_weight=0.1,
                         router_z_weight=0.01)
    np_params = jax_params(jcfg, seed=8)
    toks = tokens(9)
    want, jgrads = jax.value_and_grad(jt.loss_fn)(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(toks), jcfg)
    params = params_from_jax(np_params, device="cpu")
    leaves = [t.requires_grad_() for _, t in tt.named_tensors(params)]
    got = tt.loss_fn(params, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    plain = tt.loss_fn(params, torch.from_numpy(toks),
                       dataclasses.replace(tcfg, aux_loss_weight=0.0,
                                           router_z_weight=0.0))
    assert float(got.detach()) > float(plain.detach())   # aux added
    grads = torch.autograd.grad(got, leaves)
    jnamed = dict(tt.named_tensors(jax.tree.map(np.asarray, jgrads)))
    for (name, _), g in zip(tt.named_tensors(params), grads):
        scale = float(np.abs(jnamed[name]).max())
        np.testing.assert_allclose(g.numpy(), jnamed[name], rtol=0,
                                   atol=GRAD_SCALE_TOL * scale,
                                   err_msg=name)


# Adam's first updates are lr * g / (|g| + 1e-8): an entry whose
# gradient is f32 rounding noise around zero (observed: -8.1e-9 in JAX
# against -8.8e-10 here, where the tensor's largest entry is 1.4e-2)
# moves by an arbitrary fraction of a step in each framework, and the
# moments carry that into later steps.  Expert weights have many such
# entries (an expert's column sums over the few tokens routed to it).
# Entries whose JAX gradient was ever nonzero and below NOISE_BAND of
# its tensor's largest entry (fewer than 5% of each tensor) are held to
# two steps per step taken (opposite directions at most); every other
# entry to PARAM_ATOL.  (Exact zeros, as the embedding rows of unseen
# tokens have, are exact on both sides.)
NOISE_BAND = 1e-5
LR = 3e-4


def assert_params_close(tparams, jparams, noisy, steps):
    want = dict(tt.named_tensors(jax.tree.map(np.asarray, jparams)))
    got = tt.named_tensors(tparams)
    assert sorted(want) == sorted(name for name, _ in got)
    for name, t in got:
        diff = np.abs(t.detach().numpy() - want[name])
        band = noisy[name]
        assert band.mean() < 0.05, name
        assert diff[~band].max(initial=0.0) <= PARAM_ATOL, name
        assert diff[band].max(initial=0.0) <= 2 * LR * steps, name


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_train_steps_equal_jax(dispatch):
    """One and three AdamW steps from the same parameters and batches,
    with the load-balance loss on: losses and parameters against JAX's
    ``make_train_step`` on a one-device mesh (where gmm runs JAX's
    ep-sharded path, which equals its single-device one)."""
    jcfg, tcfg = configs(moe_dispatch=dispatch, aux_loss_weight=0.01)
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    jstep, jinit = jt.make_train_step(jcfg, mesh)
    jparams, jopt = jinit(jax.random.PRNGKey(2))
    np_params = jax.tree.map(np.array, jparams)
    tstep, _ = tt.make_train_step(tcfg, device="cpu")
    tparams = params_from_jax(np_params, device="cpu")
    leaves = [t.requires_grad_() for _, t in tt.named_tensors(tparams)]
    topt = tt.make_optimizer()(leaves)
    grad_fn = jax.jit(jax.grad(lambda p, x: jt.loss_fn(p, x, jcfg)))
    noisy = {name: np.zeros(p.shape, bool)
             for name, p in tt.named_tensors(np_params)}
    for i in range(3):
        toks = tokens(10 + i)
        # the gradient of this step, taken before the step donates
        # jparams' buffers
        for name, g in tt.named_tensors(jax.tree.map(
                np.asarray, grad_fn(jparams, jnp.asarray(toks)))):
            noisy[name] |= (g != 0) & (np.abs(g)
                                       < NOISE_BAND * np.abs(g).max())
        jparams, jopt, jloss = jstep(jparams, jopt, jnp.asarray(toks))
        tparams, topt, tloss = tstep(tparams, topt, toks)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=LOSS_RTOL, err_msg=f"step {i + 1}")
        if i in (0, 2):
            assert_params_close(tparams, jparams, noisy, i + 1)


def test_gmm_forward_equals_dense_forward():
    """gmm routing is dropless: the same function as dense dispatch."""
    _, tcfg = configs(moe_dispatch="gmm", n_kv_heads=2)
    params = tt.init_params(tcfg, torch.Generator().manual_seed(3),
                            device="cpu")
    toks = torch.from_numpy(tokens(11, b=2, t=32)).long()
    got = tt.forward(params, toks, tcfg)
    want = tt.forward(params, toks,
                      dataclasses.replace(tcfg, moe_dispatch="dense"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("dispatch", ["capacity", "gmm"])
def test_every_moe_parameter_gets_a_gradient_and_moves(dispatch):
    _, tcfg = configs(moe_dispatch=dispatch, aux_loss_weight=0.01)
    step, init_state = tt.make_train_step(tcfg, device="cpu")
    params, opt = init_state(torch.Generator().manual_seed(1))
    before = [t.detach().clone() for _, t in tt.named_tensors(params)]
    params, opt, loss = step(params, opt, tokens(12))
    assert np.isfinite(float(loss))
    names = [name for name, _ in tt.named_tensors(params)]
    assert "layers.0.router" in names
    for (name, t), old in zip(tt.named_tensors(params), before):
        assert t.grad is not None and t.grad.abs().sum() > 0, name
        assert not torch.equal(t.detach(), old), name


def test_moe_remat_equals_no_remat():
    """``remat`` recomputes the layer, routing included, in the
    backward: the same losses and parameters, aux losses on."""
    results = []
    for remat in (False, True):
        _, tcfg = configs(moe_dispatch="gmm", aux_loss_weight=0.01,
                          router_z_weight=0.01, remat=remat)
        step, init_state = tt.make_train_step(tcfg, device="cpu")
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


def test_gmm_routing_pads_each_expert_to_blocks():
    """The dispatch's row maps: every routed (token, pick) lands in its
    expert's padded group, padding rows stay zero, and the output is
    the gate-weighted sum of the token's expert MLPs."""
    _, tcfg = configs(moe_dispatch="gmm")
    layer, x = layer_inputs(13)
    _, tl = both_layers(layer)
    xt = torch.from_numpy(x)
    gates = tt._router_gates(xt, tl, tcfg)[0]
    gv, ids = torch.topk(gates.reshape(-1, 4), 2, dim=-1)
    out = tt._gmm_dispatch_combine(xt.reshape(-1, 48), gv, ids,
                                   tl["w_in"], tl["w_out"], 4, 128)
    gelu = torch.nn.functional.gelu
    want = torch.zeros_like(out)
    for n in range(out.shape[0]):
        for j in range(2):
            e = int(ids[n, j])
            h = gelu(xt.reshape(-1, 48)[n] @ tl["w_in"][e],
                     approximate="tanh")
            want[n] += gv[n, j] * (h @ tl["w_out"][e])
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
