"""The port's ring and Ulysses attention (k8s_dra_driver_tpu_torch/ops/
ring_attention.py, ulysses_attention.py) against the JAX package's, on
the same global inputs.

The port runs on spawned gloo process groups of 2 and 4 ranks
(tests/torch_dist.py), each rank on its own shard; JAX runs
``ring_attention`` / ``ulysses_attention`` on the virtual CPU mesh of
the same shape (tests/conftest.py) on the global arrays.  Outputs and
the gradients of sum(out * g) in q, k and v are held at 2e-5, the JAX
tests' own tolerance (tests/test_workloads.py): f32, summation order
only.  On the CPU every hop runs the kernels' plain versions (K1's
block entry, K3/K4); JAX's CPU ring runs its XLA block update.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist
from k8s_dra_driver_tpu.ops.ring_attention import ring_attention
from k8s_dra_driver_tpu.ops.ulysses_attention import ulysses_attention
from k8s_dra_driver_tpu.parallel.mesh import MeshSpec, make_mesh

TOL = 2e-5

# name: (world, spec, method, dict(h, h_kv, causal, window, seg))
CASES = {
    "ring_sp2_causal_gqa": (2, dict(sp=2), "ring", dict()),
    "ring_sp2_window": (2, dict(sp=2), "ring", dict(window=24)),
    "ring_sp2_segments_window": (2, dict(sp=2), "ring",
                                 dict(seg=True, window=40)),
    "ring_sp2_non_causal_segments": (2, dict(sp=2), "ring",
                                     dict(causal=False, seg=True)),
    "ulysses_sp2_causal_gqa": (2, dict(sp=2), "ulysses", dict()),
    "ulysses_sp2_segments_window": (2, dict(sp=2), "ulysses",
                                    dict(seg=True, window=20)),
    "ring_sp4_segments_window_gqa": (4, dict(sp=4), "ring",
                                     dict(seg=True, window=30)),
    "ring_sp4_mqa": (4, dict(sp=4), "ring", dict(h_kv=1)),
    "ring_dp2_sp2": (4, dict(dp=2, sp=2), "ring", dict(seg=True)),
    "ulysses_sp4": (4, dict(sp=4), "ulysses", dict(h=8, h_kv=4,
                                                   window=24)),
    "ulysses_dp2_sp2_segments": (4, dict(dp=2, sp=2), "ulysses",
                                 dict(seg=True)),
}


def inputs(name):
    """Global numpy inputs of one case: B=2 T=64 D=16, H=4 over H_kv=2
    unless the case says otherwise."""
    world, spec, method, kw = CASES[name]
    c = dict(dict(h=4, h_kv=2, causal=True, window=None, seg=False), **kw)
    rng = np.random.default_rng(sorted(CASES).index(name))
    b, t, d = 2, 64, 16
    q = rng.standard_normal((b, t, c["h"], d), np.float32)
    k = rng.standard_normal((b, t, c["h_kv"], d), np.float32)
    v = rng.standard_normal((b, t, c["h_kv"], d), np.float32)
    g = rng.standard_normal((b, t, c["h"], d), np.float32)
    seg = (np.cumsum(rng.integers(0, 12, (b, t)) == 0, axis=1)
           .astype(np.int32) if c["seg"] else None)
    return dict(spec=spec, method=method, causal=c["causal"],
                window=c["window"], qkv=(q, k, v), g=g, seg=seg)


def jax_reference(name, c):
    """JAX's output and input gradients on its mesh of the same shape."""
    world = CASES[name][0]
    mesh = make_mesh(MeshSpec(**c["spec"]), devices=jax.devices()[:world])
    attend = ring_attention if c["method"] == "ring" else ulysses_attention
    seg = None if c["seg"] is None else jnp.asarray(c["seg"])

    @jax.jit
    def run(q, k, v, g):
        f = functools.partial(attend, mesh=mesh, causal=c["causal"],
                              window=c["window"], segment_ids=seg)
        out, vjp = jax.vjp(lambda q, k, v: f(q, k, v), q, k, v)
        return (out, *vjp(g))

    got = run(*(jnp.asarray(x) for x in c["qkv"]), jnp.asarray(c["g"]))
    return dict(zip(("out", "dq", "dk", "dv"),
                    (np.asarray(x) for x in got)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case: (the port's global arrays from its ranks, JAX's).
    One spawned group per world size runs all its cases while JAX
    computes its references here."""
    cases = {name: inputs(name) for name in CASES}
    groups = {}
    for world in (2, 4):
        names = [n for n in CASES if CASES[n][0] == world]
        groups[world] = (names, torch_dist.Group(
            torch_dist.attention_worker, world,
            ([cases[n] for n in names],),
            tmp_path_factory.mktemp(f"ring{world}")))
    want = {name: jax_reference(name, c) for name, c in cases.items()}
    out = {}
    for names, group in groups.values():
        ranks = group.join()
        for i, name in enumerate(names):
            per_rank = [r[i] for r in ranks]
            coords = [r["coords"] for r in per_rank]
            out[name] = ({key: torch_dist.unshard(
                [r[key] for r in per_rank], coords)
                for key in ("out", "dq", "dk", "dv")}, want[name])
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(results, name):
    got, want = results[name]
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL,
                                   err_msg=f"{name}: {key}")
