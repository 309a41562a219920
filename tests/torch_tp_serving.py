"""The shared half of the tensor-parallel serving tests
(test_torch_tp_serving.py: the row functions, the entry points, the
refusals and the parent's ops; test_torch_tp_serving_engine.py: the
step engine, fused blocks, the paged pool and the prefix cache;
test_torch_tp_serving_spec.py: both speculation sources, step and
fused, and sampled rows; test_torch_tp_serving_variants.py: int8
weights, LoRA and an MoE config).

A mode is an engine configuration (:data:`MODES`).  :func:`run_modes`
starts one spawned gloo group per mesh (``torch_dist.tp_serving_worker``:
``ServingEngine(..., mesh=)`` on each rank's ``shard_params`` blocks)
and, meanwhile, drains the JAX package's ``ServingEngine`` on
``jt.shard_params`` over the virtual 8-device CPU mesh in this process
(:func:`jax_streams`).  f32, 2 layers, narrow widths, every head count
divisible by tp.
"""

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_dist
from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from torch_plugin import short_dir

#: JAX's own forward tolerance (tests/test_workloads.py), relative to
#: the largest value; the tensor-parallel decode tests' too
FWD_TOL = 2e-4
FIELDS = dict(vocab=80, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
              d_head=8, d_ff=64, max_seq=48)
#: the draft model: the target's widths at one layer (:func:`weights`)
DRAFT = dict(n_layers=1)
MOE = dict(n_experts=4, top_k=2)
SLOTS = 3
#: the two meshes every mode drains on: (world, spec)
MESHES = {"tp2": (2, dict(tp=2)), "dp2_tp2": (4, dict(dp=2, tp=2))}
#: the LoRA mode's adapters (rank 4, loud enough to move greedy tokens)
LORA_RANK, LORA_NAMES = 4, ("la", "lb")
#: the engine's sampling filter in the sampled modes
TOP_K = 5

#: name -> (engine keywords, what the mode adds: "draft" a draft model,
#: "sampled" sampled requests, "lora" an adapter pool, "quant" int8
#: weights, "moe" an MoE config)
MODES = {
    "step": ({}, ()),
    "chain4": (dict(chain_steps=4), ()),
    "chunk": (dict(prefill_chunk=4), ()),
    "paged": (dict(kv_layout="paged", kv_block_size=4), ()),
    "prefix": (dict(prefix_cache=4), ()),
    "ngram": (dict(draft_source="ngram", draft_len=3), ()),
    "ngram_fused": (dict(draft_source="ngram", draft_len=3,
                         chain_steps=2), ()),
    "draft": (dict(draft_len=2), ("draft",)),
    "draft_fused": (dict(draft_len=2, chain_steps=2), ("draft",)),
    "sampled": (dict(top_k=TOP_K), ("sampled",)),
    "sampled_fused": (dict(top_k=TOP_K, chain_steps=3), ("sampled",)),
    "quant": ({}, ("quant",)),
    "lora": ({}, ("lora",)),
    "moe": ({}, ("moe",)),
}


def prompts() -> list:
    """Five prompts of two lengths (8 and 12: each length compiles JAX's
    fills once): the third shares the first's first five tokens and the
    fifth the second's first nine, so the prefix cache hits and the
    n-gram lookup finds repeats."""
    rng = np.random.default_rng(0)
    v = FIELDS["vocab"]
    p0 = rng.integers(0, v, 8)
    p1 = rng.integers(0, v, 12)
    out = [p0, p1, np.concatenate([p0[:5], rng.integers(0, v, 3)]),
           rng.integers(0, v, 12), np.concatenate([p1[:9], p1[:3]])]
    return [p.astype(np.int32) for p in out]


#: each request's max_new; requests 1 and 3 sample in the sampled modes,
#: requests 1 and 3 ask for adapter "la" and 2 for "lb" in the LoRA mode
MAX_NEW = (6, 4, 7, 5, 3)
SAMPLED = {1: 0.8, 3: 1.1}
ADAPTERS = {1: "la", 2: "lb", 3: "la"}


def requests(mode: str, cls=ts.Request) -> list:
    """The mode's five requests as ``cls`` (the port's or JAX's
    ``Request``)."""
    extras = MODES[mode][1]
    out = []
    for i, (pr, m) in enumerate(zip(prompts(), MAX_NEW)):
        kw = {}
        if "sampled" in extras and i in SAMPLED:
            kw.update(temperature=SAMPLED[i], seed=100 + i)
        if "lora" in extras and i in ADAPTERS:
            kw["adapter"] = ADAPTERS[i]
        out.append(cls(uid=f"r{i}", prompt=pr, max_new=m, **kw))
    return out


def port_cfg(mode: str, draft: bool = False) -> dict:
    """The port config's fields of ``mode`` (its draft model's with
    ``draft``)."""
    fields = dict(FIELDS, dtype=torch.float32)
    if "moe" in MODES[mode][1]:
        fields.update(MOE)
    if draft:
        fields.update(DRAFT)
    return fields


def jax_cfg(mode: str, draft: bool = False) -> jt.TransformerConfig:
    fields = port_cfg(mode, draft)
    fields["dtype"] = jnp.float32
    return jt.TransformerConfig(**fields)


@functools.lru_cache(maxsize=None)
def weights(mode: str) -> dict:
    """The mode's weights as numpy in JAX's layout: ``target``
    (``init_params`` at key 0) and, with a draft model, ``draft``.
    Cached: read only."""
    out = {"target": jax.tree.map(np.array, jt.init_params(
        jax_cfg(mode), jax.random.PRNGKey(0)))}
    if "draft" in MODES[mode][1]:
        # the target's first layer under its embedding and unembedding,
        # a draft that agrees with the target often enough to be
        # accepted
        out["draft"] = dict(out["target"],
                            layers=out["target"]["layers"][:1])
    return out


#: the adapters' factor scale (the JAX LoRA tests' 0.5)
LORA_SCALE = 0.5


def adapter_seed(name: str) -> int:
    return 1000 + sum(map(ord, name))


def adapter_source(name: str):
    """The adapter ``name``'s leaves, the same numbers in both
    packages' pools (``make_adapter`` is numpy-seeded)."""
    from k8s_dra_driver_tpu_torch.serving_lora.pool import make_adapter
    return make_adapter(tt.TransformerConfig(**port_cfg("lora")), LORA_RANK,
                        seed=adapter_seed(name), scale=LORA_SCALE)


def case(mode: str, spec: dict) -> dict:
    """What a rank needs for ``mode`` on ``spec``: numpy only."""
    return dict(mode=mode, spec=spec, cfg=port_cfg(mode),
                draft_cfg=port_cfg(mode, draft=True), weights=weights(mode),
                engine=MODES[mode][0], extras=MODES[mode][1],
                requests=[dataclasses.asdict(r) for r in requests(mode)],
                slots=SLOTS, lora=dict(
                    rank=LORA_RANK, names=LORA_NAMES, scale=LORA_SCALE,
                    seeds=[adapter_seed(n) for n in LORA_NAMES]))


# --------------------------------------------------------------------------
# The JAX side
# --------------------------------------------------------------------------

def jax_engine(mode: str, world=None, spec=None):
    """JAX's ``ServingEngine`` of ``mode`` on ``jt.shard_params`` over
    the virtual mesh (``world`` devices), on one device without
    ``world``.  int8 weights in the JAX order, ``quantize_params`` of
    the sharded params under ``jit``."""
    from k8s_dra_driver_tpu.models.quant import quantize_params
    from k8s_dra_driver_tpu.serving_lora import pool as jl
    kw, extras = MODES[mode]
    kw = dict(kw)
    w = weights(mode)
    cfg = jax_cfg(mode)
    mesh = None if world is None else torch_dist.jax_mesh(world, spec)

    def place(tree, c):
        tree = jax.tree.map(jnp.asarray, tree)
        return tree if mesh is None else jt.shard_params(tree, c, mesh)

    params = place(w["target"], cfg)
    if "quant" in extras:
        params = jax.jit(lambda p: quantize_params(p, cfg))(params)
    if "draft" in extras:
        dcfg = jax_cfg(mode, draft=True)
        kw.update(draft_params=place(w["draft"], dcfg), draft_cfg=dcfg)
    if "lora" in extras:
        pool = jl.AdapterPool(cfg, LORA_RANK, n_resident=len(LORA_NAMES))
        for name in LORA_NAMES:
            pool.register(jl.AdapterManifest(
                name, LORA_RANK, source=adapter_source(name)))
        kw["adapter_pool"] = pool
    return js.ServingEngine(params, cfg, slots=SLOTS, **kw)


def drain(eng, reqs) -> dict:
    """``{uid: prompt + generated}`` of a drained engine."""
    for r in reqs:
        eng.submit(r)
    return {f.uid: np.asarray(f.tokens) for f in eng.run()}


def jax_streams(mode: str, world=None, spec=None) -> dict:
    return drain(jax_engine(mode, world, spec), requests(mode, js.Request))


# --------------------------------------------------------------------------
# The groups
# --------------------------------------------------------------------------

def run_modes(modes, meshes=tuple(MESHES), jax_sharded=None) -> dict:
    """Every mode drained on every mesh's ranks beside JAX's sharded
    engine: ``{(mode, mesh): ([one result a rank], JAX's streams)}``.
    ``jax_sharded`` names the modes JAX drains on the mesh (default
    all); the others get None."""
    jax_sharded = modes if jax_sharded is None else jax_sharded
    groups = {}
    for m in meshes:
        world, spec = MESHES[m]
        out_dir = short_dir("tpsrv")
        groups[m] = (out_dir, torch_dist.Group(
            torch_dist.tp_serving_worker, world,
            ([case(mode, spec) for mode in modes],), out_dir))
    want = {}
    for m in meshes:
        world, spec = MESHES[m]
        for mode in modes:
            want[(mode, m)] = (jax_streams(mode, world, spec)
                               if mode in jax_sharded else None)
    out = {}
    for m, (out_dir, group) in groups.items():
        try:
            ranks = group.join()
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        for i, mode in enumerate(modes):
            out[(mode, m)] = ([r[i] for r in ranks], want[(mode, m)])
    return out


def port_streams(mode: str) -> dict:
    """The port's single-process engine of ``mode`` on the whole
    weights, on the CPU: the sampled rows' reference (the JAX engine
    draws from ``jax.random``, which the port's generators cannot
    reproduce)."""
    from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
    kw, extras = MODES[mode]
    cfg = tt.TransformerConfig(**port_cfg(mode))
    params = params_from_jax(weights(mode)["target"], device="cpu")
    assert not {"draft", "lora", "quant"} & set(extras)
    return drain(ts.ServingEngine(params, cfg, slots=SLOTS, device="cpu",
                                  **kw), requests(mode))


def check_ranks_equal(per_rank) -> dict:
    """Every rank finished every request with the same stream; returns
    rank 0's streams."""
    first = per_rank[0]["streams"]
    assert set(first) == {f"r{i}" for i in range(len(MAX_NEW))}
    for r in per_rank[1:]:
        assert set(r["streams"]) == set(first)
        for uid in first:
            np.testing.assert_array_equal(r["streams"][uid], first[uid],
                                          err_msg=uid)
    for uid, toks in first.items():
        i = int(uid[1:])
        assert len(toks) == len(prompts()[i]) + MAX_NEW[i]
    return first


def check_against(got: dict, want: dict, uids=None) -> None:
    """Every stream of ``uids`` (default all) equal, token for token."""
    for uid in (sorted(want) if uids is None else uids):
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=uid)


def greedy_uids(mode: str) -> list:
    return [r.uid for r in requests(mode) if r.temperature == 0]


# --------------------------------------------------------------------------
# mesh=None: the engine's single-process ops
# --------------------------------------------------------------------------

def single_process_drain(mode: str) -> dict:
    """``mode``'s engine without a mesh on the port's own weights
    (``init_params`` at seed 1, the draft at 3; int8 by
    ``quantize_params``; an adapter pool of LORA_NAMES on the CPU),
    drained: what the op-trace tests record."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.serving_lora.pool import (AdapterManifest,
                                                            AdapterPool)
    kw, extras = MODES[mode]
    kw = dict(kw)
    cfg = tt.TransformerConfig(**port_cfg(mode))
    params = tt.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    if "quant" in extras:
        params = quantize_params(params, cfg)
    if "draft" in extras:
        dcfg = tt.TransformerConfig(**port_cfg(mode, draft=True))
        kw.update(draft_cfg=dcfg, draft_params=tt.init_params(
            dcfg, torch.Generator().manual_seed(3), device="cpu"))
    if "lora" in extras:
        pool = AdapterPool(cfg, LORA_RANK, len(LORA_NAMES), device="cpu")
        for name in LORA_NAMES:
            pool.register(AdapterManifest(name, LORA_RANK,
                                          source=adapter_source(name)))
        kw["adapter_pool"] = pool
    eng = ts.ServingEngine(params, cfg, slots=SLOTS, device="cpu", **kw)
    return drain(eng, requests(mode))


def single_process_entry_points() -> None:
    """``speculative_generate``, ``ngram_speculative_generate`` and
    ``sample_generate`` without a mesh on the port's own weights (the
    target at seed 1, the draft at 3) and a [2, 8] prompt: what the
    op-trace test records."""
    from k8s_dra_driver_tpu_torch.models import decode as td
    from k8s_dra_driver_tpu_torch.models import speculative as tsp
    cfg = tt.TransformerConfig(**port_cfg("step"))
    dcfg = tt.TransformerConfig(**port_cfg("draft", draft=True))
    params = tt.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    draft = tt.init_params(dcfg, torch.Generator().manual_seed(3),
                           device="cpu")
    prompt = torch.as_tensor(np.stack([prompts()[0], prompts()[2]]),
                             dtype=torch.long)
    tsp.speculative_generate(params, draft, prompt, cfg, dcfg, 6,
                             draft_len=2)
    tsp.ngram_speculative_generate(params, prompt, cfg, 6, draft_len=3)
    td.sample_generate(params, prompt, cfg, 6,
                       torch.Generator().manual_seed(5), top_k=TOP_K)


# --------------------------------------------------------------------------
# The row functions and entry points (test_torch_tp_serving.py)
# --------------------------------------------------------------------------

#: three prompts of 8, the fill's slots of 4 and the prefix-hit slot,
#: windows of DRAFT_LEN + 1 forced tokens, sampled row 1
ROWS_B, ROWS_T, ROWS_SLOTS = 3, 8, 4
ROWS = dict(slot_ids=[2, 0, 3], hit_slot=1, prefix_len=5, draft_len=3,
            temps=[0.0, 0.9, 0.0], block=4, budget=[4, 3, 4], n_new=8,
            top_k=TOP_K)


def rows_case(spec: dict) -> dict:
    """What a rank needs for the row functions (the draft mode's
    weights: a 2-layer target and its 1-layer draft)."""
    rng = np.random.default_rng(4)
    v = FIELDS["vocab"]
    head = rng.integers(0, v, (ROWS_B, 4))
    # each prompt repeats its first half, so the n-gram lookup proposes
    prompts = np.concatenate([head, head], axis=1).astype(np.int32)
    window = rng.integers(0, v, (ROWS_B, ROWS["draft_len"] + 1))
    return dict(ROWS, spec=spec, cfg=port_cfg("draft"),
                draft_cfg=port_cfg("draft", draft=True),
                weights=weights("draft"), extras=("draft",),
                prompts=prompts, window=window.astype(np.int32),
                slots=ROWS_SLOTS)


def jax_rows(c: dict, world: int, spec: dict) -> dict:
    """JAX's side of :func:`torch_dist.tp_rows_worker`'s greedy half on
    ``jt.shard_params`` over the virtual mesh: the fills' first tokens
    and whole K/V, the window logits, the greedy proposals and the
    jitted entry points' tokens (``sample_generate`` at ``top_k=1``)."""
    from k8s_dra_driver_tpu.models import decode as jd
    from k8s_dra_driver_tpu.models import speculative as jsp
    cfg, dcfg = jax_cfg("draft"), jax_cfg("draft", draft=True)
    mesh = torch_dist.jax_mesh(world, spec)
    sp = jt.shard_params(jax.tree.map(jnp.asarray, c["weights"]["target"]),
                         cfg, mesh)
    dsp = jt.shard_params(jax.tree.map(jnp.asarray, c["weights"]["draft"]),
                          dcfg, mesh)
    prompts = jnp.asarray(c["prompts"])
    b, t = prompts.shape
    s, p, k = cfg.max_seq, c["prefix_len"], c["draft_len"]
    out = {}
    cache = jd.init_cache(cfg, c["slots"], s)
    first, cache, _ = jd.prefill_adopt_rows(
        sp, prompts, cfg, cache, jnp.asarray(c["slot_ids"], jnp.int32),
        jnp.zeros((b, 2), jnp.uint32), jnp.zeros(b, jnp.float32), s)
    out["fill_first"] = np.asarray(first)
    out["fill_kv"] = [np.asarray(a[:, :t]) for a in cache.k + cache.v]
    _, entry = jd.prefill(sp, prompts[:1, :p], cfg, jd.init_cache(cfg, 1, s))
    tok, cache, _, _ = jd.suffix_fill_adopt(
        sp, entry, prompts[0, p:], cfg, cache,
        jnp.asarray(c["hit_slot"], jnp.int32), jnp.zeros(2, jnp.uint32),
        jnp.asarray(0.0, jnp.float32))
    out["hit_first"] = int(tok)
    out["hit_kv"] = [np.asarray(a[c["hit_slot"], :t])
                     for a in cache.k + cache.v]
    pos = jnp.full((b,), t, jnp.int32)
    _, wcache = jd.prefill(sp, prompts, cfg, jd.init_cache(cfg, b, s))
    window = jnp.asarray(c["window"])
    logits, _ = jd.decode_window_rows(sp, window, cfg, wcache, pos)
    out["window_logits"] = np.asarray(logits)
    _, dcache = jd.prefill(dsp, prompts, dcfg, jd.init_cache(dcfg, b, s))
    props, _ = jd.draft_propose_rows(dsp, window[:, 0], dcfg, dcache, pos, k)
    out["draft_greedy"] = np.asarray(props)
    n = c["n_new"]
    toks, iters = jsp.speculative_generate(sp, dsp, prompts, cfg, dcfg, n,
                                           draft_len=k)
    out["speculative"] = [np.asarray(toks), int(iters)]
    toks, iters = jsp.ngram_speculative_generate(sp, prompts, cfg, n,
                                                 draft_len=k)
    out["ngram"] = [np.asarray(toks), int(iters)]
    out["sample_top1"] = np.asarray(jd.sample_generate(
        sp, prompts, cfg, n, jax.random.PRNGKey(5), top_k=1))
    return out


def jax_sampled(c: dict, world: int, spec: dict, port: dict) -> dict:
    """JAX's side of the sampled half on ``jt.shard_params`` over the
    virtual mesh, on what the port drew (``port``: its sampled draft's
    proposals and ``sample_generate``'s tokens at the case's ``top_k``):
    the draft's distributions the proposals were drawn from (the draft
    fed ``last`` and the first ``draft_len - 1`` proposals as a forced
    window) and the target's over the window of all of them, each
    through JAX's own temperature and top-k filter; and, for each of
    ``sample_generate``'s tokens, whether JAX's filter at temperature 1
    keeps it at its position."""
    from k8s_dra_driver_tpu.models import decode as jd
    cfg, dcfg = jax_cfg("draft"), jax_cfg("draft", draft=True)
    mesh = torch_dist.jax_mesh(world, spec)
    sp = jt.shard_params(jax.tree.map(jnp.asarray, c["weights"]["target"]),
                         cfg, mesh)
    dsp = jt.shard_params(jax.tree.map(jnp.asarray, c["weights"]["draft"]),
                          dcfg, mesh)
    prompts = jnp.asarray(c["prompts"])
    b, t = prompts.shape
    s, top_k = cfg.max_seq, c["top_k"]
    temps = jnp.asarray(c["temps"], jnp.float32)
    pos = jnp.full((b,), t, jnp.int32)
    last = jnp.asarray(c["window"])[:, :1]
    props = jnp.asarray(port["draft_sampled"], jnp.int32)

    def probs(logits, temp):
        return np.asarray(jax.nn.softmax(
            jd._filter_logits(logits, temp, top_k), axis=-1))

    _, dcache = jd.prefill(dsp, prompts, dcfg, jd.init_cache(dcfg, b, s))
    logits, _ = jd.decode_window_rows(
        dsp, jnp.concatenate([last, props[:, :-1]], axis=1), dcfg, dcache,
        pos)
    out = dict(draft_q=probs(logits, temps[:, None]))
    _, cache = jd.prefill(sp, prompts, cfg, jd.init_cache(cfg, b, s))
    logits, _ = jd.decode_window_rows(
        sp, jnp.concatenate([last, props], axis=1), cfg, cache, pos)
    out["accept_p"] = probs(logits, temps[:, None])
    seq = jnp.asarray(port["sample"], jnp.int32)
    logits, _ = jd.prefill(sp, seq[:, :-1], cfg, jd.init_cache(cfg, b, s))
    kept = jd._filter_logits(logits[:, t - 1:], 1.0, top_k) > -1e29
    out["sample_kept"] = np.asarray(jnp.take_along_axis(
        kept, seq[:, t:, None], axis=-1)[..., 0])
    return out
