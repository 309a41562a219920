"""The port's multichip certification (k8s_dra_driver_tpu_torch/
graft_entry.py) against the JAX package's (the repo root's
``__graft_entry__.py``).

- ``dryrun_multichip(8, device="cpu")``: eight gloo rank processes on
  ``MeshSpec.infer(8)`` (ep=2 x sp=2 x tp=2) train the JAX dryrun's
  three configs, and pp=4 x dp=2 its pipeline, three steps each with
  finite, decreasing losses equal on every rank; the tp-sharded decode
  emits the single-process tokens on every rank.
- Each run's first loss, on the rank body's weights and batch
  (``dryrun_params``, ``dryrun_tokens``), equals JAX's unsharded
  ``loss_fn`` on the same numpy weights within LOSS_RTOL: the cheap
  half of the JAX dryrun (its sharded steps take about a minute).
- ``entry()``'s forward, on JAX ``entry()``'s weights moved over,
  matches JAX's forward at BF16_TOL of the largest logit; the port's
  own entry builds the JAX entry's config and tokens.
- A rank that never joins fails the dryrun with ``RuntimeError`` well
  inside a short ``timeout_s``, naming the rank.
"""

import concurrent.futures
import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu_torch import graft_entry as ge
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.models.transformer import named_tensors
from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec

LOSS_RTOL = 1e-4
#: bf16 logits of two frameworks (tests/test_torch_transformer.py's bf16
#: tolerance), relative to the largest logit
BF16_TOL = 2e-2
N = 8


@pytest.fixture(scope="module")
def results():
    """The eight ranks' reports, and JAX's unsharded first losses,
    computed here while the ranks run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(ge.dryrun_multichip, N, device="cpu",
                              timeout_s=300)
        want = [jax_first_loss(run) for run in ge.dryrun_runs(N)]
        return running.result(), want


@pytest.fixture(scope="module")
def reports(results):
    return results[0]


def test_dryrun_runs_are_the_jax_dryrun_configs():
    runs = ge.dryrun_runs(N)
    assert [r.spec for r in runs] == [MeshSpec(ep=2, sp=2, tp=2)] * 3 + [
        MeshSpec(dp=2, pp=4)]
    assert [r.cfg.moe_dispatch for r in runs] == ["capacity", "dense",
                                                  "gmm", "dense"]
    assert [r.cfg.seq_parallel for r in runs[:3]] == ["ring", "ulysses",
                                                      "ring"]
    assert (runs[1].cfg.n_heads, runs[1].cfg.kv_heads) == (8, 4)
    assert [r.cfg.remat for r in runs] == [True, False, False, True]
    assert (runs[3].cfg.pp_stages, runs[3].cfg.n_layers) == (4, 4)
    assert [(r.batch, r.seq) for r in runs] == [(4, 16)] * 3 + [(16, 16)]


def test_dryrun_multichip_trains_and_decodes_on_eight_ranks(reports):
    assert [r["rank"] for r in reports] == list(range(N))
    labels = [r.label for r in ge.dryrun_runs(N)]
    for rep in reports:
        assert [run["label"] for run in rep["runs"]] == labels
        for run, first in zip(rep["runs"], reports[0]["runs"]):
            losses = run["losses"]
            assert len(losses) == ge.DRYRUN_STEPS
            assert all(np.isfinite(losses)) and losses[-1] < losses[0]
            # the global loss, the same on every rank
            np.testing.assert_allclose(losses, first["losses"], rtol=1e-6)
        assert rep["decode"]["tokens"] == reports[0]["decode"]["tokens"]
        assert np.asarray(rep["decode"]["tokens"]).shape == (
            ge.DECODE_BATCH, ge.DECODE_NEW)
    # every mesh position ran once
    coords = {tuple(sorted(r["runs"][0]["coords"].items())) for r in reports}
    assert len(coords) == N


def jax_config(cfg):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    return jt.TransformerConfig(**dict(fields, dtype=jnp.float32))


def numpy_tree(params):
    return {"embed": params["embed"].numpy(),
            "unembed": params["unembed"].numpy(),
            "ln_f": params["ln_f"].numpy(),
            "layers": [{k: v.numpy() for k, v in layer.items()}
                       for layer in params["layers"]]}


def jax_first_loss(run) -> float:
    """JAX's ``loss_fn``, unsharded, on the weights and batch every rank
    of ``run`` starts from."""
    params = numpy_tree(ge.dryrun_params(run.cfg))
    tokens = ge.dryrun_tokens(run.cfg, run.batch, run.seq)
    return float(jt.loss_fn(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(tokens), jax_config(run.cfg)))


@pytest.mark.parametrize("index", range(4))
def test_first_loss_equals_jax_unsharded_loss(results, index):
    reports, losses = results
    run, want = ge.dryrun_runs(N)[index], losses[index]
    for rep in reports:
        got = rep["runs"][index]["losses"][0]
        assert abs(got - want) <= LOSS_RTOL * abs(want), (run.label, got,
                                                          want)


def test_entry_matches_jax_entry():
    jfn, (jparams, jtokens) = jax_entry.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jtokens), np.float32)
    fn, (params, tokens) = ge.entry(device="cpu")
    assert tokens.shape == jtokens.shape and not tokens.any()
    mine = dict(named_tensors(params))
    theirs = dict(named_tensors(jax.tree.map(np.asarray, jparams)))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in theirs.items()}
    assert all(v.dtype == torch.bfloat16 for v in mine.values())
    with torch.no_grad():
        got = fn(params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device="cpu"), tokens).float().numpy()
    assert got.shape == want.shape == (4, 256, 8192)
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def test_a_rank_that_never_joins_fails_loudly(monkeypatch):
    plain = ge._rank_argv

    def argv(rank, *args):
        if rank == 1:
            return [sys.executable, "-c", "import time; time.sleep(600)"]
        return plain(rank, *args)

    monkeypatch.setattr(ge, "_rank_argv", argv)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        ge.dryrun_multichip(4, device="cpu", timeout_s=12)
    # the joined ranks give up at their groups' deadline (half the
    # run's), or the run's deadline stops them all (a loaded host's
    # torch imports): either way the run ends at its deadline, not later
    assert time.monotonic() - t0 < 12 + 10
    assert "rank 1 (still running" in str(err.value)
    assert "(deadline 12 s), killed" in str(err.value)
