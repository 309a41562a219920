"""Port weight-only int8 (k8s_dra_driver_tpu_torch/models/quant.py)
against the JAX package's models/quant.py.

The same numpy weights go through both packages' quantizers, which
agree bit for bit (f32 arithmetic, round half to even).  The K7 plain
versions are held to the interpreted Pallas kernels, and ``qeinsum`` to
JAX's ``qeinsum`` under both of JAX's routings (einsum by default, the
kernel under ``TPU_QUANT_KERNEL=1``), in f32 within 1e-5: the products
are the same, summed in another order.  On the CPU the port's K7
wrappers take their plain versions, so these tests hold the function
the kernel must compute; ``chip_smoke.py`` holds the kernel to it on
the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import quant as jq
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu_torch.models import quant as tq
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = dict(vocab=96, d_model=48, n_layers=2, n_heads=4, d_head=12,
              d_ff=96, max_seq=32)


def rnd(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def to_port(qt) -> tq.QTensor:
    return tq.QTensor(q=torch.from_numpy(np.array(qt.q)),
                      scale=torch.from_numpy(np.array(qt.scale)))


# every spec the model emits, with x and w shapes at a small size
SPECS = {
    "btd,dhk->bthk": ((2, 3, 48), (48, 4, 12)),
    "bthk,hkd->btd": ((2, 3, 4, 12), (4, 12, 48)),
    "btd,df->btf": ((2, 3, 48), (48, 96)),
    "btf,fd->btd": ((2, 3, 96), (96, 48)),
    "btd,dv->btv": ((2, 3, 48), (48, 96)),
    "btd,edf->btef": ((2, 3, 48), (4, 48, 96)),
    "btef,efd->bted": ((2, 3, 4, 96), (4, 96, 48)),
}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_quantize_for_is_bitwise_jax(spec):
    w = rnd(1, *SPECS[spec][1])
    want = jq.quantize_for(spec, jnp.asarray(w))
    got = tq.quantize_for(spec, torch.from_numpy(w))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_quantize_per_row_and_ties_are_bitwise_jax():
    """Embedding rows (contract dim 1), and values that land exactly on
    a half step: both round half to even."""
    w = rnd(2, 96, 48)
    w[0, :4] = [127.0, 0.5, 1.5, -2.5]         # scale 1: .5 ties
    want = jq.quantize(jnp.asarray(w), (1,))
    got = tq.quantize(torch.from_numpy(w), (1,))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.q[0, :4].tolist() == [127, 0, 2, -2]
    zero = tq.quantize(torch.zeros(3, 5), (0,))  # the 1e-12 floor
    assert torch.all(zero.q == 0) and torch.all(zero.scale > 0)


@pytest.mark.parametrize("m,k,n", [(1, 200, 130), (5, 96, 160),
                                   (64, 200, 130), (96, 72, 333)])
def test_int8_matmul_reference_matches_interpreted_pallas(m, k, n):
    x, w = rnd(3, m, k), rnd(4, k, n)
    qt = jq.quantize(jnp.asarray(w), (0,))
    want = jq.int8_matmul(jnp.asarray(x), qt.q, qt.scale.reshape(1, n),
                          interpret=True)
    got = tq.int8_matmul_reference(torch.from_numpy(x), to_port(qt).q,
                                   to_port(qt).scale.reshape(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(
        tq.int8_matmul(torch.from_numpy(x), to_port(qt).q,
                       to_port(qt).scale).numpy(), got.numpy())


@pytest.mark.parametrize("m", [1, 5])
def test_int8_bmm_reference_matches_interpreted_pallas(m):
    g, k, n = 3, 96, 130
    x, w = rnd(5, g, m, k), rnd(6, g, k, n)
    qt = jq.quantize(jnp.asarray(w), (1,))
    want = jq.int8_bmm(jnp.asarray(x), qt.q, qt.scale.reshape(g, 1, n),
                       interpret=True)
    pq = to_port(qt)
    got = tq.int8_bmm_reference(torch.from_numpy(x), pq.q, pq.scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # strided x (shared by every expert) and a strided output buffer
    shared = torch.from_numpy(x[0])[None].expand(g, m, k)
    buf = torch.empty((m, g, n))
    out = tq.int8_bmm(shared, pq.q, pq.scale, out=buf.permute(1, 0, 2))
    ref = tq.int8_bmm_reference(shared.contiguous(), pq.q, pq.scale)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    np.testing.assert_array_equal(buf.permute(1, 0, 2).numpy(), ref.numpy())


@pytest.mark.parametrize("routing", ["einsum", "kernel"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_qeinsum_matches_jax_both_routings(spec, routing, monkeypatch):
    """The port routes M <= 64 to K7 (its plain version here) whatever
    the environment; JAX's two routings both equal it."""
    if routing == "kernel":
        monkeypatch.setenv("TPU_QUANT_KERNEL", "1")
    else:
        monkeypatch.delenv("TPU_QUANT_KERNEL", raising=False)
    xs, ws = SPECS[spec]
    x, w = rnd(7, *xs), rnd(8, *ws)
    qt = jq.quantize_for(spec, jnp.asarray(w))
    want = jq.qeinsum(spec, jnp.asarray(x), qt)
    got = tq.qeinsum(spec, torch.from_numpy(x), to_port(qt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    deq = torch.einsum(spec, torch.from_numpy(x), to_port(qt).dequant())
    np.testing.assert_allclose(got.numpy(), deq.numpy(), **TOL)


@pytest.mark.parametrize("spec", ["btd,dhk->bthk", "btd,edf->btef",
                                  "btef,efd->bted"])
def test_qeinsum_large_m_takes_the_einsum_and_matches_jax(spec):
    xs, ws = SPECS[spec]
    xs = (xs[0], 40) + xs[2:]                       # M = 80 rows
    x, w = rnd(9, *xs), rnd(10, *ws)
    qt = jq.quantize_for(spec, jnp.asarray(w))
    want = jq.qeinsum(spec, jnp.asarray(x), qt)
    got = tq.qeinsum(spec, torch.from_numpy(x), to_port(qt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("spec,rows", [("btd,dhk->bthk", 3),
                                       ("bthk,hkd->btd", 40),
                                       ("btd,edf->btef", 3),
                                       ("btef,efd->bted", 40)])
def test_qeinsum_dx_matches_jax_grad(spec, rows):
    xs, ws = SPECS[spec]
    xs = (xs[0], rows) + xs[2:]
    x, w = rnd(11, *xs), rnd(12, *ws)
    qt = jq.quantize_for(spec, jnp.asarray(w))
    out_shape = jq.qeinsum(spec, jnp.asarray(x), qt).shape
    r = rnd(13, *out_shape)
    want = jax.grad(lambda a: jnp.sum(jq.qeinsum(spec, a, qt) * r))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    pq = to_port(qt)
    (tq.qeinsum(spec, xt, pq) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
    assert pq.q.grad is None and pq.scale.grad is None


def test_take_rows_on_qtensor_matches_jax():
    table = rnd(14, 96, 48)
    qt = jq.quantize(jnp.asarray(table), (1,))
    tokens = np.array([[0, 3, 95], [7, 7, 1]])
    want = jq.take_rows(qt, jnp.asarray(tokens), jnp.float32)
    got = tq.take_rows(to_port(qt), torch.from_numpy(tokens), torch.float32)
    assert got.shape == (2, 3, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_use_kernel_routes_by_rows_only(monkeypatch):
    """M <= 64 reaches the K7 wrappers and M > 64 the einsum, with or
    without the JAX package's opt-in variable."""
    monkeypatch.setenv("TPU_QUANT_KERNEL", "0")
    assert tq._use_kernel(64) and not tq._use_kernel(65)
    calls = []

    def spy(real, name):
        def call(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        return call

    monkeypatch.setattr(tq, "int8_matmul", spy(tq.int8_matmul, "matmul"))
    monkeypatch.setattr(tq, "int8_bmm", spy(tq.int8_bmm, "bmm"))
    w = tq.quantize_for("btd,df->btf", torch.from_numpy(rnd(15, 48, 96)))
    we = tq.quantize_for("btd,edf->btef",
                         torch.from_numpy(rnd(16, 4, 48, 96)))
    for t, want in ((32, ["matmul", "bmm"]), (33, [])):
        calls.clear()
        x = torch.from_numpy(rnd(17, 2, t, 48))
        tq.qeinsum("btd,df->btf", x, w)
        tq.qeinsum("btd,edf->btef", x, we)
        assert calls == want, (t, calls)


def jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jt.init_params(cfg, jax.random.PRNGKey(seed)))


def moe_fields():
    return dict(FIELDS, n_experts=4, top_k=2)


@pytest.mark.parametrize("fields", [FIELDS, moe_fields()],
                         ids=["dense", "moe"])
def test_quantize_params_through_convert_equals_port(fields):
    """The JAX package's quantized tree, carried over by
    ``params_from_jax``, equals the port's own quantization of the same
    weights leaf for leaf, and ``quantized_bytes`` agrees."""
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **fields)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **fields)
    jp = jax_params(jcfg)
    jqp = jq.quantize_params(jp, jcfg)
    carried = params_from_jax(jax.tree.map(np.asarray, jqp), device="cpu")
    own = tq.quantize_params(params_from_jax(jp, device="cpu"), tcfg)

    def flat(tree):
        out = {"embed": tree["embed"], "unembed": tree["unembed"],
               "ln_f": tree["ln_f"]}
        for i, layer in enumerate(tree["layers"]):
            out.update({f"{i}.{k}": v for k, v in layer.items()})
        return out

    a, b = flat(carried), flat(own)
    assert a.keys() == b.keys()
    for name in a:
        assert type(a[name]) is type(b[name]), name
        if isinstance(a[name], tq.QTensor):
            assert torch.equal(a[name].q, b[name].q), name
            assert torch.equal(a[name].scale, b[name].scale), name
        else:
            assert torch.equal(a[name], b[name]), name
    assert isinstance(b["0.router" if "0.router" in b else "0.ln1"],
                      torch.Tensor)
    assert tq.quantized_bytes(own) == jq.quantized_bytes(jqp)
    stored, full = tq.quantized_bytes(own)
    assert stored < 0.6 * full


def test_quantized_forward_matches_jax_and_tracks_full_precision():
    """Quantized logits equal the JAX package's quantized logits, and
    track the full-precision ones as the JAX package's own test holds
    them (mean relative error < 0.05, argmax agreement > 0.9)."""
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **FIELDS)
    jp = jax_params(jcfg)
    tp = params_from_jax(jp, device="cpu")
    qp = tq.quantize_params(tp, tcfg)
    tokens = np.random.default_rng(18).integers(0, 96, (2, 16))
    want = jt.forward(jq.quantize_params(jp, jcfg), jnp.asarray(tokens),
                      jcfg)
    tok = torch.as_tensor(tokens)
    quant = tt.forward(qp, tok, tcfg)
    np.testing.assert_allclose(quant.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    full = tt.forward(tp, tok, tcfg)
    rel = (quant - full).abs() / full.std().clamp_min(1e-6)
    assert float(rel.mean()) < 0.05
    agree = (quant.argmax(-1) == full.argmax(-1)).float().mean()
    assert float(agree) > 0.9


def test_quantized_forward_is_differentiable_in_x():
    """The gradient of a frozen quantized MoE forward in its input
    equals JAX's, within 2e-4 of its largest entry: two layers of f32
    attention, router softmax and norms backward, summed in another
    order."""
    fields = moe_fields()
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **fields)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **fields)
    jp = jax_params(jcfg)
    jqp = jq.quantize_params(jp, jcfg)
    qp = params_from_jax(jax.tree.map(np.asarray, jqp), device="cpu")
    tokens = np.random.default_rng(19).integers(0, 96, (2, 8))

    def jloss(delta):
        h = jq.take_rows(jqp["embed"], jnp.asarray(tokens),
                         jnp.float32) + delta
        for layer in jqp["layers"]:
            h = jt._layer_forward(h, layer, jcfg, None)
        h = jt.rms_norm(h, jqp["ln_f"])
        return jnp.mean(jq.ein("btd,dv->btv", h, jqp["unembed"]) ** 2)

    want = jax.grad(jloss)(jnp.zeros((2, 8, 48)))
    delta = torch.zeros((2, 8, 48), requires_grad=True)
    h = tq.take_rows(qp["embed"], torch.as_tensor(tokens),
                     torch.float32) + delta
    for layer in qp["layers"]:
        h = tt._layer_forward(h, layer, tcfg)
    h = tt.rms_norm(h, qp["ln_f"])
    (tq.ein("btd,dv->btv", h, qp["unembed"]) ** 2).mean().backward()
    top = float(np.abs(np.asarray(want)).max())
    assert top > 0
    np.testing.assert_allclose(delta.grad.numpy(), np.asarray(want),
                               atol=2e-4 * top, rtol=0)


def test_gmm_refuses_quantized_experts_as_jax_does():
    fields = dict(moe_fields(), moe_dispatch="gmm")
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **fields)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **fields)
    jp = jax_params(jcfg)
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(NotImplementedError) as jerr:
        jt.forward(jq.quantize_params(jp, jcfg), jnp.asarray(tokens), jcfg)
    qp = tq.quantize_params(params_from_jax(jp, device="cpu"), tcfg)
    with pytest.raises(NotImplementedError) as terr:
        tt.forward(qp, torch.as_tensor(tokens), tcfg)
    assert str(terr.value) == str(jerr.value)
    # the serving config runs the dense dispatch on the same weights
    dense = dataclasses.replace(tcfg, moe_dispatch="dense")
    assert torch.isfinite(tt.forward(qp, torch.as_tensor(tokens),
                                     dense)).all()


def test_quantize_params_refuses_pipeline_stages():
    """Pipeline stages are no longer refused: staged params are unstaged
    first, as JAX's ``quantize_params`` does (serving is single-device),
    and quantize to the layers list bit for bit."""
    cfg = tt.TransformerConfig(dtype=torch.float32, pp_stages=2, **FIELDS)
    tp = params_from_jax(jax_params(jt.TransformerConfig(
        dtype=jnp.float32, **FIELDS)), device="cpu")
    got = tq.quantize_params(tt.stage_params(tp, cfg), cfg)
    want = tq.quantize_params(tp, cfg)
    assert len(got["layers"]) == cfg.n_layers
    for (name, a), (_, b) in zip(tt.named_tensors(got),
                                 tt.named_tensors(want)):
        if isinstance(a, tq.QTensor):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale,
                                                         b.scale), name
        else:
            assert torch.equal(a, b), name


def test_k7_wrappers_refuse_bad_arguments():
    x = torch.zeros(2, 8)
    q = torch.zeros(8, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        tq.int8_matmul(x, q.float(), torch.ones(4))
    with pytest.raises(ValueError, match="does not match"):
        tq.int8_matmul(torch.zeros(2, 7), q, torch.ones(4))
    with pytest.raises(ValueError, match="scale"):
        tq.int8_matmul(x, q, torch.ones(5))
    with pytest.raises(ValueError, match="out must be"):
        tq.int8_bmm(x[None], q[None], torch.ones(1, 1, 4),
                    out=torch.empty(1, 2, 5))
