"""Pipeline parallelism in the port (k8s_dra_driver_tpu_torch/parallel/
pipeline.py, the pp path of models/transformer.py) against the
sequential stages and the JAX package.

- ``pipeline_apply`` of tests/test_pipeline.py's residual-MLP stages on
  spawned gloo groups of 2 and 4 ranks (tests/torch_dist.py) at (S, M)
  = (2, 1), (2, 2), (2, 4) and (4, 4), with and without stage
  checkpointing: the output on every rank, and the gradients of
  sum(out * wgt) in x and in every stage's parameters (each rank holds
  its own stage's), against the stages run in sequence in this process
  at PIPE_TOL (JAX's test tolerances).
- The transformer over ``dp=2 x pp=2`` and ``pp=4`` (and capacity MoE
  with remat over ``ep=2 x pp=2``, the twin of JAX's
  ``test_composes_with_remat_and_moe``): ``forward`` and two train
  steps against JAX's on the same mesh, at tests/test_torch_tp.py's
  tolerances, every leaf's first gradient included; each stage's
  parameters and AdamW moments are its own ``[1, L/S, ...]`` blocks.
- Staged and unstaged parameters round-trip bit-equal and serve alike
  (``greedy_generate``, ``quantize_params``, ``ServingEngine``), as JAX's
  ``test_staged_params_decode_and_quantize`` and
  ``test_staged_pp_params_serve_exactly`` have them.
- JAX's refusals, in its words: "pp axis", "sp", "gmm", and
  ``pipeline_apply``'s "divisible", "stage axis" and "split".
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
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.models.decode import greedy_generate
from k8s_dra_driver_tpu_torch.models.quant import quantize_params
from k8s_dra_driver_tpu_torch.models.serving import Request, ServingEngine
from k8s_dra_driver_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                        split_layers,
                                                        stack_stages)
from test_torch_ep import FakeMesh
from test_torch_tp import (FWD_TOL, GRAD_TOL, LOSS_RTOL, assert_params_close,
                           rel)

PIPE_TOL = 1e-5
PIPE_GRAD_TOL = 1e-4

# (stages, microbatches, checkpoint_stages)
PIPES = [(2, 1, True), (2, 1, False), (2, 2, True), (2, 2, False),
         (2, 4, True), (2, 4, False), (4, 4, True), (4, 4, False)]

BASE = dict(vocab=96, d_model=48, n_layers=4, n_heads=4, n_kv_heads=2,
            d_head=12, d_ff=96, max_seq=64)
# name: (spec, config fields)
MODEL = {
    "dp2_pp2": (dict(dp=2, pp=2), dict(pp_stages=2, attention_window=6)),
    "pp4": (dict(pp=4), dict(pp_stages=4)),
}
MODEL_TRAIN = {
    "dp2_pp2": (dict(dp=2, pp=2), dict(pp_stages=2)),
    "pp4": (dict(pp=4), dict(pp_stages=4)),
    "capacity_ep2_pp2_remat": (dict(ep=2, pp=2), dict(
        n_layers=2, pp_stages=2, remat=True, n_experts=4, top_k=2,
        moe_dispatch="capacity")),
}


def configs(**kw):
    fields = dict(BASE, **kw)
    return (jt.TransformerConfig(dtype=jnp.float32, **fields),
            dict(dtype=torch.float32, **fields))


def tokens(seed, b=8, t=16):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], (b, t)).astype(np.int32)


def pipe_case(s, m, checkpoint):
    rng = np.random.default_rng(10 * s + m)
    d, hidden, batch, lps = 8, 16, 8, 2
    return dict(spec=dict(pp=s), m=m, checkpoint=checkpoint, stages={
        "w1": (rng.standard_normal((s, lps, d, hidden)) * 0.3).astype(
            np.float32),
        "w2": (rng.standard_normal((s, lps, hidden, d)) * 0.3).astype(
            np.float32)},
        x=rng.standard_normal((batch, d)).astype(np.float32),
        wgt=rng.standard_normal((batch, d)).astype(np.float32))


def sequential(case):
    """The stages in sequence, in this process: (out, dx, grads)."""
    stacked = {k: torch.from_numpy(v).requires_grad_()
               for k, v in case["stages"].items()}
    x = torch.from_numpy(case["x"]).requires_grad_()
    y = x
    for s in range(stacked["w1"].shape[0]):
        y = torch_dist.mlp_stage({k: v[s] for k, v in stacked.items()}, y)
    (y * torch.from_numpy(case["wgt"])).sum().backward()
    return (y.detach().numpy(), x.grad.numpy(),
            {k: v.grad.numpy() for k, v in stacked.items()})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    pipes = {w: [pipe_case(*p) for p in PIPES if p[0] == w] for w in (2, 4)}
    fwd, train = {}, {}
    for i, (name, (spec, kw)) in enumerate(sorted(MODEL.items())):
        jcfg, tcfg = configs(**kw)
        params = jax.tree.map(np.array, jt.init_params(
            jcfg, jax.random.PRNGKey(1)))
        fwd[name] = (dict(kind="forward", spec=spec, cfg=tcfg,
                          params=params, tokens=tokens(i)), jcfg)
    for i, (name, (spec, kw)) in enumerate(sorted(MODEL_TRAIN.items())):
        jcfg, tcfg = configs(**kw)
        batches = [tokens(10 * i + j) for j in range(2)]
        init, finish = torch_dist.jax_train(jcfg, 4, spec, batches)
        train[name] = (dict(kind="train", spec=spec, cfg=tcfg,
                            params=init, tokens=batches), finish)
    f_names, t_names = sorted(fwd), sorted(train)
    groups = {
        2: torch_dist.Group(torch_dist.pipeline_worker, 2, (pipes[2],),
                            tmp_path_factory.mktemp("pipe2")),
        4: torch_dist.Group(torch_dist.jobs_worker, 4, ([
            (torch_dist.pipeline_worker, (pipes[4],)),
            (torch_dist.model_worker,
             ([fwd[n][0] for n in f_names] + [train[n][0]
                                              for n in t_names],))],),
            tmp_path_factory.mktemp("pipe4"))}
    train_want = {name: (c, finish()) for name, (c, finish) in train.items()}
    fwd_want = {name: torch_dist.jax_forward(
        jcfg, c["params"], c["tokens"], 4, c["spec"])
        for name, (c, jcfg) in fwd.items()}
    out = {"pipe": {}, "forward": {}, "train": {}}
    for world, group in groups.items():
        ranks = group.join()
        pipe_res = [r for r in ranks] if world == 2 else [r[0] for r in ranks]
        for i, case in enumerate(pipes[world]):
            key = (case["spec"]["pp"], case["m"], case["checkpoint"])
            out["pipe"][key] = ([r[i] for r in pipe_res], sequential(case))
        if world == 4:
            for i, name in enumerate(f_names):
                per_rank = [r[1][i] for r in ranks]
                out["forward"][name] = (torch_dist.unshard(
                    [r["logits"] for r in per_rank],
                    [r["coords"] for r in per_rank]), fwd_want[name])
            for j, name in enumerate(t_names):
                out["train"][name] = (
                    [r[1][len(f_names) + j] for r in ranks],
                    train_want[name])
    return out


@pytest.mark.parametrize("s,m,checkpoint", PIPES)
def test_pipeline_apply_matches_sequential(results, s, m, checkpoint):
    per_rank, (out, dx, grads) = results["pipe"][(s, m, checkpoint)]
    for r in per_rank:
        np.testing.assert_allclose(r["out"], out, atol=PIPE_TOL,
                                   rtol=PIPE_TOL)
    # each stage's gradient lives on its rank, x's on stage 0's
    np.testing.assert_allclose(sum(r["dx"] for r in per_rank), dx,
                               atol=PIPE_GRAD_TOL, rtol=PIPE_GRAD_TOL)
    for key, want in grads.items():
        got = sum(r["grads"][key] for r in per_rank)
        np.testing.assert_allclose(got, want, atol=PIPE_GRAD_TOL,
                                   rtol=PIPE_GRAD_TOL)
        for r in per_rank:
            mine = r["coords"]["pp"]
            others = np.delete(r["grads"][key], mine, axis=0)
            assert not others.any()


@pytest.mark.parametrize("name", sorted(MODEL))
def test_pp_forward_matches_jax(results, name):
    got, want = results["forward"][name]
    assert got.shape == want.shape == (8, 16, BASE["vocab"])
    assert rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("name", sorted(MODEL_TRAIN))
def test_pp_train_steps_match_jax_leaf_by_leaf(results, name):
    per_rank, (case, want) = results["train"][name]
    cfg = tt.TransformerConfig(**case["cfg"])
    lps = split_layers(cfg.n_layers, cfg.pp_stages)
    for r in per_rank:
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        assert sorted(r["grads"]) == sorted(want["grads"])
        for key, g in r["grads"].items():
            assert rel(g, want["grads"][key]) <= GRAD_TOL, key
        for key, value in r["params"].items():
            assert_params_close(value, want["final"][key],
                                want["grads"][key], key)
        # per-stage residency: this stage's [1, L/S, ...] block and its
        # AdamW moments, as test_params_live_per_stage pins for JAX
        shape, moment = r["blocks"]["stages.wq"]
        assert shape[:2] == (1, lps) and moment == shape


def test_staged_round_trip_is_bit_equal():
    _, kw = MODEL["pp4"]
    cfg = tt.TransformerConfig(**configs(**kw)[1])
    params = tt.init_params(cfg, device="cpu")
    staged = tt.stage_params(params, cfg)
    assert staged["stages"]["wq"].shape[:2] == (4, 1)
    back = tt.unstage_params(staged, cfg)
    for (na, a), (nb, b) in zip(tt.named_tensors(params),
                                tt.named_tensors(back)):
        assert na == nb and torch.equal(a, b)
    toks = torch.from_numpy(tokens(3)).long()
    assert torch.equal(tt.forward(staged, toks, cfg),
                       tt.forward(params, toks, cfg))


def test_staged_params_decode_quantize_and_serve_like_jax():
    """JAX's test_staged_params_decode_and_quantize and
    test_staged_pp_params_serve_exactly on the port, on JAX's weights:
    staged params generate JAX's tokens, quantize to the layers list and
    serve exactly as the unstaged ones."""
    jcfg, tkw = configs(pp_stages=4)
    cfg = tt.TransformerConfig(**tkw)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    from k8s_dra_driver_tpu.models.decode import \
        greedy_generate as jgreedy
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, 8), 0,
                                           jcfg.vocab))
    want = np.asarray(jgreedy(jparams, jnp.asarray(prompt), jcfg,
                              n_tokens=4))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    staged = tt.stage_params(params, cfg)
    out = greedy_generate(staged, torch.from_numpy(prompt).long(), cfg,
                          n_tokens=4)
    np.testing.assert_array_equal(out.numpy(), want)
    q = quantize_params(staged, cfg)
    assert "layers" in q and len(q["layers"]) == cfg.n_layers
    eng = ServingEngine(staged, cfg, slots=2, device="cpu")
    eng.submit(Request(uid="pp", prompt=prompt[0], max_new=4))
    done = eng.run()
    np.testing.assert_array_equal(done[0].tokens, want[0])


def test_pp_refusals_match_jax():
    cfg = tt.TransformerConfig(**configs(pp_stages=2)[1])
    params = tt.init_params(cfg, device="cpu")
    toks = torch.zeros((4, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="pp axis"):
        tt.forward(params, toks, cfg, mesh=FakeMesh(dp=4))
    with pytest.raises(ValueError, match="pp axis"):
        tt.forward(params, toks, dataclasses.replace(cfg, pp_stages=4),
                   mesh=FakeMesh(dp=2, pp=2))
    with pytest.raises(ValueError, match="sp"):
        tt.forward(params, toks, cfg, mesh=FakeMesh(dp=2, sp=2, pp=2))
    with pytest.raises(ValueError, match="segment_ids"):
        tt.forward(params, toks, cfg, segment_ids=toks,
                   mesh=FakeMesh(pp=2))
    moe = dataclasses.replace(cfg, n_experts=4, moe_dispatch="gmm")
    with pytest.raises(NotImplementedError, match="gmm"):
        tt.forward(tt.init_params(moe, device="cpu"), toks, moe,
                   mesh=FakeMesh(dp=4, pp=2))


def test_pipeline_apply_refusals_match_jax():
    stages = stack_stages([{"w1": torch.zeros(1, 8, 8),
                            "w2": torch.zeros(1, 8, 8)}] * 2)
    with pytest.raises(ValueError, match="divisible"):
        pipeline_apply(torch_dist.mlp_stage, stages, torch.zeros(6, 8),
                       mesh=FakeMesh(pp=2), n_microbatches=4)
    with pytest.raises(ValueError, match="stage axis"):
        pipeline_apply(torch_dist.mlp_stage, stages, torch.zeros(4, 8),
                       mesh=FakeMesh(pp=4), n_microbatches=2)
    assert split_layers(8, 4) == 2
    with pytest.raises(ValueError, match="split"):
        split_layers(6, 4)
