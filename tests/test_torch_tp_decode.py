"""Tensor-parallel decoding in the port (k8s_dra_driver_tpu_torch/models/
decode.py's ``mesh=``) against the JAX package's decode on GSPMD-sharded
weights.

Spawned gloo groups of 2 and 4 ranks (tests/torch_dist.py) decode on
their blocks of JAX's weights (``params_from_jax``, then
``shard_params``); JAX runs ``prefill`` + ``decode_step_rows`` in this
process on ``jt.shard_params`` over the virtual 8-device CPU mesh, as
tests/test_torch_tp.py holds ``forward``.  f32, 2 layers.

- ``MeshSpec(tp=2)`` (MHA and GQA), ``tp=4`` (GQA) and ``dp=2 x
  tp=2``: the prefill logits and six ``decode_step_rows`` steps fed the
  same tokens at FWD_TOL of their largest magnitude, on every rank; the
  greedy tokens of ``prefill`` + ``decode_step_rows`` argmax steps and
  of ``greedy_generate(mesh=)`` equal JAX's single-device
  ``greedy_generate`` exactly; each rank's cache holds ``H_kv/tp``
  heads.
- ``mesh=None`` runs the single-process path's ops, one for one: the
  aten op trace of prefill, per-row and aligned decode steps and
  ``greedy_generate`` hashes to the parent tree's (recorded on the
  tree before the ``mesh=`` keyword), so its outputs are the parent's
  bit for bit; so do the traces of the paged steps (both reads), the
  int8 KV cache, int8 weights, LoRA rows and an MoE config (recorded on
  the tree before tp carried them).
- Under tp > 1 pp-staged params raise ``NotImplementedError`` naming
  ROADMAP's item; heads that do not divide by tp are refused in
  ``shard_params``' words.  The fused block runs under a mesh
  (test_torch_tp_serving.py).  What tp decode
  once refused besides (the int8 KV cache, ``QTensor`` weights, the
  paged path, LoRA, MoE) is held against JAX in
  test_torch_tp_decode_a0.py, test_torch_tp_decode_a0_lora.py,
  test_torch_tp_decode_a0_weights.py and test_torch_tp_decode_a0_moe.py.
"""

import hashlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_dist
from k8s_dra_driver_tpu.models import decode as jd
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu_torch.models import decode as td
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.quant import quantize_params
from k8s_dra_driver_tpu_torch.parallel import mesh as tmesh
from k8s_dra_driver_tpu_torch.serving_lora.pool import (AdapterManifest,
                                                        AdapterPool,
                                                        make_adapter)

#: JAX's own forward tolerance (tests/test_workloads.py), relative to
#: the largest logit
FWD_TOL = 2e-4
BASE = dict(vocab=80, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=8, d_ff=64, max_seq=32)
B, PROMPT, N_NEW = 4, 8, 6

# name: (world, spec, config fields)
CASES = {
    "tp2_mha": (2, dict(tp=2), dict(n_kv_heads=0)),
    "tp2_gqa": (2, dict(tp=2), dict()),
    "tp4_gqa": (4, dict(tp=4), dict(n_heads=8, n_kv_heads=4)),
    "dp2_tp2": (4, dict(dp=2, tp=2), dict()),
}


def configs(**kw):
    fields = dict(BASE, **kw)
    return (jt.TransformerConfig(dtype=jnp.float32, **fields),
            dict(dtype=torch.float32, **fields))


def ints(seed, shape):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], shape).astype(np.int32)


def rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One spawned group per world size decodes its cases; JAX computes
    its sharded decode and single-device tokens here meanwhile."""
    cases = {}
    for i, (name, (world, spec, kw)) in enumerate(sorted(CASES.items())):
        jcfg, tcfg = configs(**kw)
        params = jax.tree.map(np.array, jt.init_params(
            jcfg, jax.random.PRNGKey(10 + i)))
        cases[name] = (dict(spec=spec, cfg=tcfg, params=params,
                            prompt=ints(20 + i, (B, PROMPT)),
                            forced=ints(40 + i, (B, N_NEW)), n_new=N_NEW),
                       jcfg)
    groups = {}
    for world in (2, 4):
        names = sorted(n for n in CASES if CASES[n][0] == world)
        groups[world] = (names, torch_dist.Group(
            torch_dist.tp_decode_worker, world,
            ([cases[n][0] for n in names],),
            tmp_path_factory.mktemp(f"tp_decode{world}")))
    want = {}
    for name, (c, jcfg) in cases.items():
        world, spec, _ = CASES[name]
        prefill, steps, _ = torch_dist.jax_tp_decode(
            jcfg, c["params"], c["prompt"], c["forced"], N_NEW, world, spec,
            greedy=False)
        tokens = np.asarray(jd.greedy_generate(
            jax.tree.map(jnp.asarray, c["params"]), jnp.asarray(c["prompt"]),
            jcfg, n_tokens=N_NEW))[:, PROMPT:]
        want[name] = dict(prefill=prefill, steps=steps, tokens=tokens)
    out = {}
    for world, (names, group) in groups.items():
        ranks = group.join()
        for i, name in enumerate(names):
            out[name] = ([r[i] for r in ranks], want[name])
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_decode_logits_match_jax_sharded_decode(results, name):
    per_rank, want = results[name]
    for r in per_rank:
        assert r["prefill"].shape == want["prefill"].shape == (
            B, PROMPT, BASE["vocab"])
        assert rel(r["prefill"], want["prefill"]) <= FWD_TOL
        assert r["steps"].shape == want["steps"].shape
        assert rel(r["steps"], want["steps"]) <= FWD_TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_greedy_tokens_equal_jax_single_device(results, name):
    per_rank, want = results[name]
    for r in per_rank:
        np.testing.assert_array_equal(r["greedy"], want["tokens"])
        np.testing.assert_array_equal(r["generated"], want["tokens"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_cache_holds_local_kv_heads(results, name):
    world, spec, kw = CASES[name]
    cfg = tt.TransformerConfig(**configs(**kw)[1])
    for r in results[name][0]:
        assert r["cache_shape"] == (B, BASE["max_seq"],
                                    cfg.kv_heads // spec["tp"],
                                    BASE["d_head"])


# --------------------------------------------------------------------------
# mesh=None: the parent's ops
# --------------------------------------------------------------------------

class OpTrace(TorchDispatchMode):
    """Every aten op dispatched inside, with its outputs' shapes and
    dtypes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else [out]
        self.ops.append(str(func) + ":" + ",".join(
            f"{tuple(o.shape)}{o.dtype}" for o in outs
            if isinstance(o, torch.Tensor)))
        return out


#: sha256 of the op trace of :func:`single_process_decode` and its op
#: count, recorded on the tree before decode took ``mesh=``
PARENT_TRACE = {
    "mha": (5707, "4e4f4958790ed315"),
    "gqa": (5817, "fbf1538a43e5bf5d"),
}


def single_process_decode(cfg, params, toks):
    """prefill, five per-row steps, an aligned step, greedy_generate."""
    cache = td.init_cache(cfg, 4, 32, device="cpu")
    lg, cache = td.prefill(params, toks, cfg, cache)
    pos = torch.full((4,), 8)
    tok = lg[:, -1].argmax(-1)
    for _ in range(5):
        lg, cache = td.decode_step_rows(params, tok[:, None], cfg, cache, pos)
        tok, pos = lg.argmax(-1), pos + 1
    again = td.init_cache(cfg, 4, 32, device="cpu")
    lg, again = td.prefill(params, toks, cfg, again)
    td.decode_step(params, lg[:, -1].argmax(-1)[:, None], cfg, again)
    td.greedy_generate(params, toks, cfg, 6)


@pytest.mark.parametrize("name", sorted(PARENT_TRACE))
def test_no_mesh_decode_runs_the_parent_ops(name):
    cfg = tt.TransformerConfig(
        vocab=96, d_model=48, n_layers=2, n_heads=4, d_head=12, d_ff=96,
        max_seq=32, dtype=torch.float32,
        n_kv_heads=0 if name == "mha" else 2)
    params = tt.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    toks = torch.randint(0, 96, (4, 8),
                         generator=torch.Generator().manual_seed(2))
    trace = OpTrace()
    with trace:
        single_process_decode(cfg, params, toks)
    digest = hashlib.sha256("\n".join(trace.ops).encode()).hexdigest()
    assert (len(trace.ops), digest[:16]) == PARENT_TRACE[name]


#: sha256 of the op trace of :func:`single_process_variant` and its op
#: count, recorded on the tree before tp decode carried the variants
PARENT_VARIANT_TRACE = {
    "paged": (4667, "da7d65f58b761729"),
    "paged_kernel": (4707, "f019a2352758f4f1"),
    "int8kv": (3709, "e2b1a9e380ca9f64"),
    "quant": (2801, "44e00fda9be73038"),
    "lora": (2002, "5177975c4c8be748"),
    "moe": (3905, "f77a05a56f5f2d34"),
}


def single_process_variant(variant, cfg, params, toks, lora):
    """Ten paged steps (the plain or the kernel's read) and a paged
    window, or a prefill, three per-row steps and (without LoRA)
    ``greedy_generate``."""
    if variant.startswith("paged"):
        pool = td.init_paged_pool(cfg, 13, 4, device="cpu")
        tables = torch.arange(1, 13, dtype=torch.int32).reshape(4, 3)
        for i in range(10):
            col = toks[:, i] if i < 8 else lg.argmax(-1)
            lg, pool = td.paged_decode_step_rows(
                params, col[:, None], cfg, pool, tables, torch.full((4,), i),
                use_kernel=variant == "paged_kernel", lora=lora)
        td.paged_window_rows(params, toks[:, :2], cfg, pool, tables,
                             torch.full((4,), 9), lora=lora)
        return
    cache = td.init_cache(cfg, 4, 32, device="cpu")
    lg, cache = td.prefill(params, toks, cfg, cache)
    pos, tok = torch.full((4,), 8), lg[:, -1].argmax(-1)
    for _ in range(3):
        lg, cache = td.decode_step_rows(params, tok[:, None], cfg, cache, pos,
                                        lora=lora)
        tok, pos = lg.argmax(-1), pos + 1
    if lora is None:
        td.greedy_generate(params, toks, cfg, 4)


@pytest.mark.parametrize("variant", sorted(PARENT_VARIANT_TRACE))
def test_no_mesh_variants_run_the_parent_ops(variant):
    kw = dict(vocab=96, d_model=48, n_layers=2, n_heads=4, d_head=12,
              d_ff=96, max_seq=32, dtype=torch.float32, n_kv_heads=2)
    if variant == "int8kv":
        kw["kv_cache_dtype"] = "int8"
    if variant == "moe":
        kw.update(n_experts=4, top_k=2)
    cfg = tt.TransformerConfig(**kw)
    params = tt.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    if variant == "quant":
        params = quantize_params(params, cfg)
    toks = torch.randint(0, 96, (4, 8),
                         generator=torch.Generator().manual_seed(2))
    lora = None
    if variant == "lora":
        pool = AdapterPool(cfg, 4, 3, device="cpu")
        for i, name in enumerate("abc"):
            pool.register(AdapterManifest(
                name, 4, source=make_adapter(cfg, 4, 10 + i)))
        slots = [pool.acquire(name) for name in "abc"]
        lora = (torch.tensor([0] + slots), pool.buffers)
    trace = OpTrace()
    with trace:
        single_process_variant(variant, cfg, params, toks, lora)
    digest = hashlib.sha256("\n".join(trace.ops).encode()).hexdigest()
    assert (len(trace.ops), digest[:16]) == PARENT_VARIANT_TRACE[variant]


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def fake_mesh(**axes):
    """A mesh's spec and coordinates, no process group: what the
    refusals and the head check read."""
    spec = tmesh.MeshSpec(**axes)
    return types.SimpleNamespace(
        spec=spec, coords=tmesh.mesh_coords(0, spec),
        size=lambda axis: spec.axis_sizes()[axis])


def small(**kw):
    return tt.TransformerConfig(**dict(BASE, dtype=torch.float32, **kw))


def refused(fn, what):
    with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP Queue "
                                                  f"A, item A3"):
        fn()


def test_tp_refuses_moe_and_pp_staged():
    """Of the two refusals this test held, pp-staged params under tp
    stay (the JAX package's decode unstages them onto one device); MoE
    configs are carried under any mesh now
    (test_torch_tp_decode_a0_moe.py)."""
    mesh = fake_mesh(tp=2)
    refused(lambda: td.init_cache(small(pp_stages=2), 1, device="cpu",
                                  mesh=mesh), "pp-staged")


def test_tp_refuses_heads_that_do_not_divide_in_shard_params_words():
    mesh = fake_mesh(tp=2)
    with pytest.raises(ValueError, match="should be divisible by 2, but "
                                         "it is equal to 3"):
        td.init_cache(small(n_heads=6, n_kv_heads=3), 1, device="cpu",
                      mesh=mesh)
    with pytest.raises(ValueError, match="should be divisible by 2, but "
                                         "it is equal to 3"):
        td.init_cache(small(n_heads=3, n_kv_heads=0, d_ff=64), 1,
                      device="cpu", mesh=mesh)


def test_tp_one_mesh_and_no_mesh_carry_everything():
    """Without tp (no mesh, or a mesh whose tp is 1) nothing is refused
    and the cache holds every KV head."""
    cfg = small(kv_cache_dtype="int8")
    for mesh in (None, fake_mesh(dp=2)):
        cache = td.init_cache(cfg, 1, device="cpu", mesh=mesh)
        assert cache.k[0].shape[2] == cfg.kv_heads
