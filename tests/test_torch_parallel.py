"""The port's process mesh, rendezvous and the transformer's mesh path
(k8s_dra_driver_tpu_torch/parallel/, models/transformer.py) against the
JAX package's.

- ``spec_from_env`` against the JAX one on the same env dicts, the
  ``ContractError`` cases included.
- On spawned gloo groups of 2 and 4 ranks (tests/torch_dist.py), each
  rank standing its group up through ``rendezvous.initialize``:
  ``gang_psum``, ``make_mesh`` over every axis (tp, ep and pp meshes
  and their row-major coordinates and lines), and the transformer's
  mesh path.  ``forward`` with ``MeshSpec(sp=2)`` (ring and Ulysses) and
  ``MeshSpec(dp=2, sp=2)`` is held against JAX's ``forward`` on the
  virtual CPU mesh of the same shape and against the single-device
  port at 2e-4 (tests/test_workloads.py's tolerance);
  ``make_train_step`` over three global batches against JAX's
  ``make_train_step`` on the same mesh, losses at
  tests/test_torch_train.py's LOSS_RTOL and the parameters after the
  steps at its PARAM_ATOL.  f32 throughout; JAX's parameters move over
  with ``params_from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.parallel import rendezvous as jrv
from k8s_dra_driver_tpu.parallel.mesh import MeshSpec, make_mesh
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.parallel import mesh as tmesh
from k8s_dra_driver_tpu_torch.parallel import rendezvous as trv

FWD_TOL = 2e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4

BASE = dict(vocab=96, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=12, d_ff=96, max_seq=64)

# name: (world, spec, config fields, with segments)
FORWARD = {
    "ring_sp2": (2, dict(sp=2), dict(), False),
    "ring_sp2_window_segments": (2, dict(sp=2),
                                 dict(attention_window=5), True),
    "ulysses_sp2": (2, dict(sp=2), dict(seq_parallel="ulysses"), True),
    "ring_dp2_sp2": (4, dict(dp=2, sp=2), dict(), True),
    "ulysses_dp2_sp2": (4, dict(dp=2, sp=2),
                        dict(seq_parallel="ulysses"), False),
    "dp2": (2, dict(dp=2), dict(), False),
}
TRAIN = {
    "ring_sp2_segments": (2, dict(sp=2), dict(), True),
    "ulysses_sp2": (2, dict(sp=2), dict(seq_parallel="ulysses"), False),
    "ring_dp2_sp2_window": (4, dict(dp=2, sp=2),
                            dict(attention_window=6), False),
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


def jax_mesh(world, spec):
    return make_mesh(MeshSpec(**spec), devices=jax.devices()[:world])


def forward_case(name):
    world, spec, kw, with_seg = FORWARD[name]
    jcfg, tcfg = configs(**kw)
    params = jax.tree.map(np.array, jt.init_params(jcfg,
                                                   jax.random.PRNGKey(1)))
    seed = sorted(FORWARD).index(name)
    return dict(kind="forward", spec=spec, cfg=tcfg, params=params,
                tokens=tokens(seed),
                seg=segments(seed + 50) if with_seg else None), jcfg


def jax_forward(name, c, jcfg):
    world = FORWARD[name][0]
    seg = None if c["seg"] is None else jnp.asarray(c["seg"])
    fn = jax.jit(lambda p, t, s: jt.forward(p, t, jcfg,
                                            jax_mesh(world, c["spec"]),
                                            segment_ids=s))
    return np.asarray(fn(jax.tree.map(jnp.asarray, c["params"]),
                         jnp.asarray(c["tokens"]), seg))


def train_case(name):
    world, spec, kw, with_seg = TRAIN[name]
    jcfg, tcfg = configs(**kw)
    seed = 10 * sorted(TRAIN).index(name)
    return dict(kind="train", spec=spec, cfg=tcfg,
                tokens=[tokens(seed + i) for i in range(3)],
                seg=[segments(seed + 20 + i) for i in range(3)]
                if with_seg else None), jcfg


def jax_train(name, c, jcfg):
    """JAX's three steps on its mesh; fills in the initial parameters
    (as numpy, before any donating step) and returns the losses and the
    final parameters."""
    world = TRAIN[name][0]
    step, init_state = jt.make_train_step(jcfg, jax_mesh(world, c["spec"]))
    params, opt = init_state(jax.random.PRNGKey(2))
    c["params"] = jax.tree.map(np.array, params)
    losses = []
    for i, toks in enumerate(c["tokens"]):
        seg = None if c["seg"] is None else jnp.asarray(c["seg"][i])
        params, opt, loss = step(params, opt, jnp.asarray(toks), seg)
        losses.append(float(loss))
    return losses, dict(tt.named_tensors(jax.tree.map(np.asarray,
                                                      params)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One spawned group per world size runs its contract checks, its
    forward cases and its train cases; JAX computes its references
    here, its forwards while the groups run."""
    fwd = {name: forward_case(name) for name in FORWARD}
    train = {name: train_case(name) for name in TRAIN}
    # JAX's train state first: the groups need its initial parameters
    train_want = {name: jax_train(name, c, jcfg)
                  for name, (c, jcfg) in train.items()}
    groups = {}
    for world in (2, 4):
        f_names = [n for n in FORWARD if FORWARD[n][0] == world]
        t_names = [n for n in TRAIN if TRAIN[n][0] == world]
        jobs = [(torch_dist.contract_worker, ()),
                (torch_dist.model_worker,
                 ([fwd[n][0] for n in f_names]
                  + [train[n][0] for n in t_names],))]
        groups[world] = (f_names, t_names, torch_dist.Group(
            torch_dist.jobs_worker, world, (jobs,),
            tmp_path_factory.mktemp(f"model{world}")))
    fwd_want = {name: jax_forward(name, c, jcfg)
                for name, (c, jcfg) in fwd.items()}
    out = {"contract": {}, "forward": {}, "train": {}}
    for world, (f_names, t_names, group) in groups.items():
        ranks = group.join()
        out["contract"][world] = [r[0] for r in ranks]
        kinds = [("forward", n) for n in f_names] + [("train", n)
                                                     for n in t_names]
        for i, (kind, name) in enumerate(kinds):
            per_rank = [r[1][i] for r in ranks]
            if kind == "forward":
                logits = torch_dist.unshard(
                    [r["logits"] for r in per_rank],
                    [r["coords"] for r in per_rank])
                out[kind][name] = (logits, fwd_want[name], fwd[name][0])
            else:
                out[kind][name] = (per_rank, train_want[name])
    return out


def relative_error(got, want) -> float:
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_mesh_forward_matches_jax_and_the_single_device_port(results, name):
    got, want, c = results["forward"][name]
    assert got.shape == want.shape == (4, 16, BASE["vocab"])
    assert relative_error(got, want) <= FWD_TOL
    single = tt.forward(params_from_jax(c["params"], device="cpu"),
                        torch.from_numpy(c["tokens"]),
                        tt.TransformerConfig(**c["cfg"]),
                        None if c["seg"] is None
                        else torch.from_numpy(c["seg"]))
    assert relative_error(got, single.detach().numpy()) <= FWD_TOL


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_mesh_train_steps_match_jax(results, name):
    """Three AdamW steps on global batches: every rank reports JAX's
    global loss, and every rank's replica ends at JAX's parameters."""
    per_rank, (want_losses, want_params) = results["train"][name]
    for r in per_rank:
        np.testing.assert_allclose(r["losses"], want_losses,
                                   rtol=LOSS_RTOL)
        assert sorted(r["params"]) == sorted(want_params)
        for key, value in r["params"].items():
            np.testing.assert_allclose(value, want_params[key],
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_gang_psum_and_mesh_refusals(results, world):
    """gang_psum; make_mesh refuses a spec of another size, in JAX's
    words; tp, ep and pp meshes (and on 4 ranks tp x pp and dp x ep)
    form, each rank at its row-major coordinates, its lines along each
    axis the ranks that differ from it there alone, and a sum over a
    line adds exactly those ranks."""
    for rank, r in enumerate(results["contract"][world]):
        assert r["psum"] == world * (world + 1) / 2
        kind, msg = r["mismatch"]
        assert kind == "ValueError" and "wants" in msg
        assert {"tp", "ep", "pp"} <= set(r["meshes"])
        for name, (sizes, coords, lines, sums) in r["meshes"].items():
            spec = tmesh.MeshSpec(**sizes)
            assert coords == tmesh.mesh_coords(rank, spec), name
            for axis, line in lines.items():
                want = [tmesh.mesh_rank({**coords, axis: i}, spec)
                        for i in range(sizes[axis])]
                assert line == want and rank in line, (name, axis)
                assert sums[axis] == sum(want), (name, axis)
        sizes, coords = r["default"]
        assert sizes["dp"] == world and coords["dp"] == rank


ENVS = {
    "ok": {"TPU_COORDINATOR_ADDRESS": "10.0.0.1:8476",
           "TPU_WORKER_ID": "1", "TPU_NUM_WORKERS": "4",
           "TPU_RENDEZVOUS_BARRIER_TIMEOUT_S": "30",
           "TPU_RENDEZVOUS_CHANNEL": "7", "TPU_TOPOLOGY": "2x2"},
    "hostnames": {"TPU_COORDINATOR_ADDRESS": "coord:1",
                  "TPU_WORKER_ID": "0",
                  "TPU_WORKER_HOSTNAMES": "a,b,,c"},
    "empty_timeout": {"TPU_COORDINATOR_ADDRESS": "h:2", "TPU_WORKER_ID": "0",
                      "TPU_NUM_WORKERS": "1",
                      "TPU_RENDEZVOUS_BARRIER_TIMEOUT_S": ""},
    "no_address": {"TPU_WORKER_ID": "0", "TPU_NUM_WORKERS": "2"},
    "address_without_port": {"TPU_COORDINATOR_ADDRESS": "host",
                             "TPU_WORKER_ID": "0", "TPU_NUM_WORKERS": "2"},
    "bad_worker_id": {"TPU_COORDINATOR_ADDRESS": "h:1",
                      "TPU_WORKER_ID": "x", "TPU_NUM_WORKERS": "2"},
    "missing_worker_id": {"TPU_COORDINATOR_ADDRESS": "h:1",
                          "TPU_NUM_WORKERS": "2"},
    "bad_num_workers": {"TPU_COORDINATOR_ADDRESS": "h:1",
                        "TPU_WORKER_ID": "0", "TPU_NUM_WORKERS": "two"},
    "no_gang_size": {"TPU_COORDINATOR_ADDRESS": "h:1", "TPU_WORKER_ID": "0"},
    "worker_out_of_range": {"TPU_COORDINATOR_ADDRESS": "h:1",
                            "TPU_WORKER_ID": "2", "TPU_NUM_WORKERS": "2"},
    "bad_timeout": {"TPU_COORDINATOR_ADDRESS": "h:1", "TPU_WORKER_ID": "0",
                    "TPU_NUM_WORKERS": "2",
                    "TPU_RENDEZVOUS_BARRIER_TIMEOUT_S": "soon"},
    "bad_channel": {"TPU_COORDINATOR_ADDRESS": "h:1", "TPU_WORKER_ID": "0",
                    "TPU_NUM_WORKERS": "2", "TPU_RENDEZVOUS_CHANNEL": "c"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_spec_from_env_matches_jax(name):
    env = ENVS[name]
    try:
        want = jrv.spec_from_env(dict(env))
    except jrv.ContractError as e:
        with pytest.raises(trv.ContractError) as got:
            trv.spec_from_env(dict(env))
        assert str(got.value) == str(e)
        return
    got = trv.spec_from_env(dict(env))
    assert got.__dict__ == want.__dict__


def test_initialize_names_the_spec_when_the_gang_never_forms():
    """A coordinator nobody serves: rank 1 of 2 waits out the
    contract's deadline and raises ContractError with the spec."""
    spec = trv.RendezvousSpec(
        coordinator_address=f"127.0.0.1:{torch_dist.free_port()}",
        worker_id=1, num_workers=2, barrier_timeout_s=1, channel=3)
    with pytest.raises(trv.ContractError, match="worker 1/2, channel 3"):
        trv.initialize(spec, backend="gloo")


def test_mesh_coords_are_row_major_over_the_axes():
    spec = tmesh.MeshSpec(dp=2, sp=3)
    coords = [tmesh.mesh_coords(r, spec) for r in range(6)]
    assert [(c["dp"], c["sp"]) for c in coords] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert [tmesh.mesh_rank(c, spec) for c in coords] == list(range(6))
    for n in (1, 2, 3, 4, 6, 8, 16):
        assert (tmesh.MeshSpec.infer(n).axis_sizes()
                == MeshSpec.infer(n).axis_sizes())


def test_mesh_path_refuses_moe_and_pipeline_configs():
    """The mesh path's refusals are now JAX's own: a pp config on a mesh
    whose pp axis differs ("pp axis"), pp with sp ("sp"), and gmm inside
    pipeline stages ("gmm"); MoE configs and pp configs otherwise run
    (tests/test_torch_ep.py, tests/test_torch_pipeline.py)."""
    from test_torch_ep import FakeMesh
    pp = tt.TransformerConfig(vocab=32, d_model=16, n_layers=2, n_heads=2,
                              d_head=8, d_ff=32, pp_stages=2,
                              dtype=torch.float32)
    toks = torch.zeros((4, 4), dtype=torch.long)
    params = tt.init_params(pp, device="cpu")
    with pytest.raises(ValueError, match="pp axis"):
        tt.forward(params, toks, pp, mesh=FakeMesh(dp=2))
    with pytest.raises(ValueError, match="sp"):
        tt.forward(params, toks, pp, mesh=FakeMesh(sp=2, pp=2))
    moe = dataclasses.replace(pp, n_experts=2, moe_dispatch="gmm")
    with pytest.raises(NotImplementedError, match="gmm"):
        tt.forward(tt.init_params(moe, device="cpu"), toks, moe,
                   mesh=FakeMesh(dp=2, pp=2))
