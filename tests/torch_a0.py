"""The shared half of the tensor-parallel decode variants' tests
(test_torch_tp_decode_a0.py: the int8 KV cache and the paged pool;
test_torch_tp_decode_a0_lora.py; test_torch_tp_decode_a0_weights.py:
int8 weights; test_torch_tp_decode_a0_moe.py).

A case is ``(world, mesh spec, variant, config fields)``.
:func:`run_cases` starts one spawned gloo group per world size
(``torch_dist.tp_decode_worker``) and, meanwhile, computes in this
process the JAX package's decode of each case on ``jt.shard_params``
over the virtual 8-device CPU mesh (its logits) and on one device (its
greedy tokens), ``torch_dist.jax_tp_decode``.  f32, 2 layers, narrow
widths.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_dist
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.parallel import mesh as tmesh

#: JAX's own forward tolerance (tests/test_workloads.py), relative to
#: the largest logit
FWD_TOL = 2e-4
BASE = dict(vocab=80, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=8, d_ff=64, max_seq=32)
B, PROMPT, N_NEW = 4, 8, 5
GQA4 = dict(n_heads=8, n_kv_heads=4)
MOE = dict(n_experts=4, top_k=2)
#: the paged variant's pool: blocks of 4 tokens, each row's 4 blocks
#: scattered over 17 (block 0 the null block)
BS, N_BLOCKS = 4, 17
#: the LoRA variant: three adapters of rank 4; rows on slots 0-3
LORA = dict(rank=4, names=["a", "b", "c"], seeds=[11, 12, 13],
            rows=[0, 1, 2, 3])
#: each case's seed offset (its weights, prompt, forced tokens and block
#: tables), fixed by name whichever file holds the case
SEEDS = {"int8kv_tp2": 0, "int8kv_tp4": 1, "lora_dp2_tp2": 2, "lora_tp2": 3,
         "paged_tp2": 4, "paged_tp4": 5, "moe_ep2": 0, "moe_ep2_tp2": 1,
         "moe_tp2": 2, "quant_dp2_tp2": 3, "quant_tp2": 4}


def configs(**kw):
    fields = dict(BASE, **kw)
    return (jt.TransformerConfig(dtype=jnp.float32, **fields),
            dict(dtype=torch.float32, **fields))


def small(**kw):
    return tt.TransformerConfig(**dict(BASE, dtype=torch.float32, **kw))


def ints(seed, shape):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], shape).astype(np.int32)


def rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def tables(seed) -> np.ndarray:
    """Each row's blocks: a seeded permutation of blocks 1..16."""
    n = (PROMPT + N_NEW + BS - 1) // BS
    perm = np.random.default_rng(seed).permutation(N_BLOCKS - 1) + 1
    return perm[:B * n].reshape(B, n).astype(np.int32)


def lora_buffers(tcfg):
    """The port's pool of LORA's adapters on the CPU: (slot of each
    row, whole buffers as numpy) for JAX."""
    pool, slots = torch_dist.a0_lora(tt.TransformerConfig(**tcfg), LORA)
    rows = np.array([0] + slots)[LORA["rows"]]
    return rows, tuple(tuple(a.numpy() for a in layer)
                       for layer in pool.buffers)


def case_params(cases: dict, name: str):
    """(JAX config, numpy weights) of case ``name``: ``init_params`` at a
    key of its seed offset."""
    jcfg, _ = configs(**cases[name][3])
    key = jax.random.PRNGKey(50 + SEEDS[name])
    return jcfg, jax.tree.map(np.array, jt.init_params(jcfg, key))


def run_cases(cases: dict, tmp_path_factory) -> dict:
    """Every case's ranks' results beside JAX's: ``{name: ([one result a
    rank], {"prefill", "steps", "tokens"})}``."""
    jobs = {}
    for name, (world, spec, variant, kw) in sorted(cases.items()):
        i = SEEDS[name]
        jcfg, params = case_params(cases, name)
        c = dict(spec=spec, cfg=configs(**kw)[1], params=params,
                 variant=variant, prompt=ints(60 + i, (B, PROMPT)),
                 forced=ints(80 + i, (B, N_NEW)), n_new=N_NEW)
        if variant == "paged":
            c.update(tables=tables(i), bs=BS, n_blocks=N_BLOCKS)
        if variant == "lora":
            c["lora"] = LORA
        jobs[name] = (c, jcfg)
    groups = {}
    for world in sorted({w for w, _, _, _ in cases.values()}):
        names = sorted(n for n in cases if cases[n][0] == world)
        groups[world] = (names, torch_dist.Group(
            torch_dist.tp_decode_worker, world,
            ([jobs[n][0] for n in names],),
            tmp_path_factory.mktemp(f"tp_decode_a0_{world}")))
    want = {}
    for name, (c, jcfg) in jobs.items():
        world, spec, variant, _ = cases[name]
        kw = dict(quant=variant == "quant")
        if variant == "lora":
            kw["lora"] = lora_buffers(c["cfg"])
        if variant == "paged":
            kw["paged"] = (N_BLOCKS, BS, c["tables"])
        args = (jcfg, c["params"], c["prompt"], c["forced"], N_NEW)
        prefill, steps, _ = torch_dist.jax_tp_decode(*args, world, spec,
                                                     greedy=False, **kw)
        _, _, tokens = torch_dist.jax_tp_decode(*args, logits=False, **kw)
        want[name] = dict(prefill=prefill, steps=steps, tokens=tokens)
    out = {}
    for world, (names, group) in groups.items():
        ranks = group.join()
        for i, name in enumerate(names):
            out[name] = ([r[i] for r in ranks], want[name])
    return out


def check_logits(result) -> None:
    """Every rank's prompt and step logits at FWD_TOL of JAX's sharded
    decode's."""
    per_rank, want = result
    for r in per_rank:
        assert r["prefill"].shape == want["prefill"].shape == (
            B, PROMPT, BASE["vocab"])
        assert rel(r["prefill"], want["prefill"]) <= FWD_TOL
        assert r["steps"].shape == want["steps"].shape == (
            B, N_NEW, BASE["vocab"])
        assert rel(r["steps"], want["steps"]) <= FWD_TOL


def check_tokens(result) -> None:
    """Every rank's greedy tokens equal to JAX's single-device run's."""
    per_rank, want = result
    for r in per_rank:
        np.testing.assert_array_equal(r["greedy"], want["tokens"])
        if "generated" in r:
            np.testing.assert_array_equal(r["generated"], want["tokens"])


def local_shapes(case):
    """What a rank of ``case`` holds: (KV heads, int8 scale shape,
    {leaf: shape or (q shape, scale shape)}, adapter cut shapes)."""
    world, spec, variant, kw = case
    cfg = small(**kw)
    tp, ep = spec.get("tp", 1), spec.get("ep", 1)
    d, h, k, f, v = (cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff,
                     cfg.vocab)
    hkv = cfg.kv_heads // tp
    e = cfg.n_experts
    leaves = {"embed": (v, d // tp), "unembed": (d // tp, v),
              "wq": (d, h // tp, k), "wk": (d, hkv, k), "wv": (d, hkv, k),
              "wo": (h // tp, k, d), "ln1": (d,), "ln2": (d,)}
    if e:
        leaves.update(router=(d, e), w_in=(e // ep, d, f // tp),
                      w_out=(e // ep, f // tp, d))
    else:
        leaves.update(w_in=(d, f // tp), w_out=(f // tp, d))
    if variant == "quant":
        scales = {"embed": (v, 1), "unembed": (1, v), "wq": (1, h // tp, k),
                  "wk": (1, hkv, k), "wv": (1, hkv, k), "wo": (1, 1, d),
                  "w_in": (1, f // tp), "w_out": (1, d)}
        leaves = {n: (s, scales[n]) if n in scales else s
                  for n, s in leaves.items()}
    scale = ((B, BASE["max_seq"], hkv, 1) if variant == "int8kv"
             else None)
    r, slots = LORA["rank"], len(LORA["names"]) + 1
    cut = [(slots, d, r), (slots, r, h // tp, k), (slots, h // tp, k, r),
           (slots, r, d)]
    return hkv, scale, leaves, cut


def check_blocks(result, case) -> None:
    """Every rank's cache (or pool), int8 scales, weights and adapter
    cut hold its blocks."""
    hkv, scale, leaves, cut = local_shapes(case)
    variant = case[2]
    for r in result[0]:
        assert r["cache_shape"][2:] == (hkv, BASE["d_head"])
        if variant != "paged":
            assert r["scale_shape"] == scale
        assert r["leaf_shapes"] == leaves
        if variant == "lora":
            assert r["lora_shapes"] == cut


def fake_mesh(rank=0, **axes):
    """A mesh's spec and coordinates at ``rank``, no process group: what
    the cuts and the cache shapes read."""
    spec = tmesh.MeshSpec(**axes)
    return types.SimpleNamespace(
        spec=spec, coords=tmesh.mesh_coords(rank, spec),
        size=lambda axis: spec.axis_sizes()[axis])
