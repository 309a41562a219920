"""Tensor-parallel serving in the port, the rows under the engine
(k8s_dra_driver_tpu_torch/models/decode.py's and speculative.py's
``mesh=``), against the JAX package's jitted rows and entry points on
GSPMD-sharded weights; the engine's refusals under tp; and the engine's
single-process ops.

- Spawned gloo groups of ``MeshSpec(tp=2)`` and ``dp=2 x tp=2``
  (tests/torch_dist.py ``tp_rows_worker``) run, on their
  ``shard_params`` blocks of a 2-layer target and its 1-layer draft:
  a fresh fill into slots (``prefill_adopt_rows``) and a prefix-hit
  fill (``suffix_fill_adopt``), whose first tokens equal JAX's and
  whose K/V equal their heads of JAX's at FWD_TOL; a window of forced
  tokens (``decode_window_rows``), its logits at FWD_TOL of JAX's; the
  greedy draft (``draft_propose_rows``), equal to JAX's; and
  ``speculative_generate``, ``ngram_speculative_generate`` and
  ``sample_generate`` at ``top_k=1``, equal to JAX's jitted entry
  points.  What draws from a generator (the sampled draft, the fused
  blocks with a sampled row, ``sample_generate`` at ``top_k=5``)
  cannot match ``jax.random``; it equals the port's single-process
  twin on the whole weights.  What the draws are made from is held to
  JAX: fed the port's sampled proposals, JAX's sharded draft and target
  through JAX's own filter give the port's draft and accept-side
  distributions at FWD_TOL, and JAX's filter keeps every token
  ``sample_generate`` drew.  Every rank returns the same, and the
  fused block equals the same steps one at a time under the mesh.
- Under tp the KV tiers and the disaggregation verbs raise
  ``NotImplementedError`` naming ROADMAP's item, as pp-staged params do.
- ``mesh=None``: the op traces of the engine's drains in every mode and
  of the three entry points hash to the parent tree's (recorded on the
  tree before the engine took ``mesh=``).
"""

import hashlib
import shutil
import types

import numpy as np
import pytest
import torch

import torch_dist
import torch_tp_serving as S
from k8s_dra_driver_tpu_torch.models import decode as td
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import speculative as tsp
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.parallel import mesh as tmesh
from test_torch_tp_decode import OpTrace
from torch_plugin import short_dir

MESH_IDS = sorted(S.MESHES)


@pytest.fixture(scope="module")
def rows():
    """``{mesh: ([one result a rank], JAX's, the single-process
    twin's)}``: the groups run while JAX and the twin compute here.
    JAX's sampled half runs on the twin's draws, which every rank's
    must equal (:func:`test_drafts_equal_jax_and_the_twin_on_every_rank`,
    :func:`test_entry_points_equal_jax_jitted_entry_points`)."""
    groups = {}
    for m in MESH_IDS:
        world, spec = S.MESHES[m]
        out_dir = short_dir("tprows")
        groups[m] = (out_dir, torch_dist.Group(
            torch_dist.tp_rows_worker, world, ([S.rows_case(spec)],),
            out_dir))
    with torch.no_grad():
        twin = torch_dist._tp_rows(td, tsp, S.rows_case({}), None)
    want = {}
    for m in MESH_IDS:
        c = S.rows_case(S.MESHES[m][1])
        want[m] = S.jax_rows(c, *S.MESHES[m])
        want[m].update(S.jax_sampled(c, *S.MESHES[m], twin))
    out = {}
    for m, (out_dir, group) in groups.items():
        try:
            out[m] = ([r[0] for r in group.join()], want[m], twin)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
    return out


def local_heads(kv: list, coords: dict) -> list:
    """This rank's KV heads of whole [..., H_kv, D] tensors."""
    n = S.FIELDS["n_kv_heads"] // 2
    lo = coords["tp"] * n
    return [a[..., lo:lo + n, :] for a in kv]


def close(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= S.FWD_TOL * np.abs(want).max()


def same_on_every_rank(per_rank, key) -> None:
    first = per_rank[0][key]
    for r in per_rank[1:]:
        pairs = (zip(r[key], first) if isinstance(first, list)
                 else [(r[key], first)])
        for a, b in pairs:
            np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("mesh", MESH_IDS)
def test_fills_equal_jax_sharded_fills(rows, mesh):
    """The fresh fill's and the prefix-hit fill's first tokens equal
    JAX's on every rank; the K/V they write are the rank's heads of
    JAX's at FWD_TOL."""
    per_rank, want, _ = rows[mesh]
    for r in per_rank:
        np.testing.assert_array_equal(r["fill_first"], want["fill_first"])
        assert r["hit_first"] == want["hit_first"]
        for name in ("fill_kv", "hit_kv"):
            mine = local_heads(want[name], r["coords"])
            assert r[name][0].shape[-2] == S.FIELDS["n_kv_heads"] // 2
            for got, ref in zip(r[name], mine):
                close(got, ref)


@pytest.mark.parametrize("mesh", MESH_IDS)
def test_window_logits_equal_jax_sharded_window(rows, mesh):
    per_rank, want, _ = rows[mesh]
    for r in per_rank:
        assert r["window_logits"].shape == (
            S.ROWS_B, S.ROWS["draft_len"] + 1, S.FIELDS["vocab"])
        close(r["window_logits"], want["window_logits"])


@pytest.mark.parametrize("mesh", MESH_IDS)
def test_drafts_equal_jax_and_the_twin_on_every_rank(rows, mesh):
    """The greedy draft's proposals equal JAX's; the sampled draft's
    proposals equal the twin's and its distributions are within FWD_TOL
    of them, the same on every rank."""
    per_rank, want, twin = rows[mesh]
    for r in per_rank:
        np.testing.assert_array_equal(r["draft_greedy"],
                                      want["draft_greedy"])
        np.testing.assert_array_equal(r["draft_sampled"],
                                      twin["draft_sampled"])
        close(r["draft_q"], twin["draft_q"])
    same_on_every_rank(per_rank, "draft_sampled")
    same_on_every_rank(per_rank, "draft_q")


@pytest.mark.parametrize("mesh", MESH_IDS)
def test_sampled_distributions_equal_jax_sharded_filters(rows, mesh):
    """On a sampled row, the draft distributions each proposal was drawn
    from and the target's accept-side distributions over the window are
    within FWD_TOL of JAX's sharded draft and target fed the same
    proposals through JAX's own temperature and top-k filter; each of
    ``sample_generate``'s tokens at ``top_k`` lies inside JAX's filter
    at its position."""
    per_rank, want, _ = rows[mesh]
    hot = np.asarray(S.ROWS["temps"]) > 0
    assert hot.any()
    for r in per_rank:
        for name in ("draft_q", "accept_p"):
            assert r[name].shape == want[name].shape
            close(r[name][hot], want[name][hot])
    assert want["sample_kept"].all()


@pytest.mark.parametrize("mesh", MESH_IDS)
def test_fused_blocks_equal_steps_under_the_mesh(rows, mesh):
    """``decode_fused_rows(mesh=)`` emits, a row, the tokens of the same
    steps one at a time (its budget's worth) and equals the twin's
    block; both speculative blocks equal the twin's; every rank packs
    the same."""
    per_rank, _, twin = rows[mesh]
    k, budget = S.ROWS["block"], S.ROWS["budget"]
    for r in per_rank:
        packed = r["fused"]
        assert list(packed[:, k]) == budget
        for i, n in enumerate(budget):
            np.testing.assert_array_equal(packed[i, :n], r["stepped"][i, :n])
        for name in ("fused", "spec_ngram", "spec_draft"):
            np.testing.assert_array_equal(r[name], twin[name], err_msg=name)
            assert r[name + "_done"] == twin[name + "_done"] == S.ROWS_B
    for name in ("fused", "stepped", "spec_ngram", "spec_draft"):
        same_on_every_rank(per_rank, name)


@pytest.mark.parametrize("mesh", MESH_IDS)
def test_entry_points_equal_jax_jitted_entry_points(rows, mesh):
    """``speculative_generate(mesh=)`` and
    ``ngram_speculative_generate(mesh=)``: tokens and iterations equal
    JAX's jitted loops' on sharded params; ``sample_generate(mesh=)`` at
    ``top_k=1`` equals JAX's, at ``top_k=5`` the twin's."""
    per_rank, want, twin = rows[mesh]
    for r in per_rank:
        for name in ("speculative", "ngram"):
            np.testing.assert_array_equal(r[name][0], want[name][0])
            assert r[name][1] == want[name][1]
        np.testing.assert_array_equal(r["sample_top1"], want["sample_top1"])
        np.testing.assert_array_equal(r["sample"], twin["sample"])
    for name in ("speculative", "ngram", "sample"):
        same_on_every_rank(per_rank, name)


# --------------------------------------------------------------------------
# Refusals under tp
# --------------------------------------------------------------------------

def fake_mesh(**axes):
    """A mesh's spec and coordinates, no process group: what the
    refusals and the cache's head count read."""
    spec = tmesh.MeshSpec(**axes)
    return types.SimpleNamespace(
        spec=spec, coords=tmesh.mesh_coords(0, spec),
        size=lambda axis: spec.axis_sizes()[axis])


def refused(what):
    return pytest.raises(NotImplementedError,
                         match=f"{what}.*ROADMAP Queue A, item A3")


def small_engine(**kw):
    cfg = tt.TransformerConfig(**S.port_cfg("step"))
    params = tt.init_params(cfg, device="cpu")
    return ts.ServingEngine(params, cfg, slots=2, device="cpu",
                            mesh=fake_mesh(tp=2), **kw)


@pytest.mark.parametrize("kw", [dict(kv_host_bytes=1 << 20),
                                dict(kv_spill_dir="unused")],
                         ids=["host", "disk"])
def test_tp_engine_refuses_the_kv_tiers(kw):
    with refused("the KV tiers"):
        small_engine(kv_layout="paged", kv_block_size=4, **kw)


@pytest.mark.parametrize("verb", ["prefill_export", "adopt_block",
                                  "export_prefix", "import_prefix"])
def test_tp_engine_refuses_the_disaggregation_verbs(verb):
    eng = small_engine(prefix_cache=2)
    req = ts.Request(uid="x", prompt=S.prompts()[0], max_new=2)
    args = {"prefill_export": (req,),
            "adopt_block": (ts.KVBlock(request=req, kv=None, first=0),),
            "export_prefix": (req.prompt,),
            "import_prefix": (req.prompt, None)}[verb]
    with refused(f"the disaggregation verb {verb}"):
        getattr(eng, verb)(*args)


def test_tp_engine_refuses_pp_staged_params():
    cfg = tt.TransformerConfig(**dict(S.port_cfg("step"), pp_stages=2))
    with refused("pp-staged"):
        ts.ServingEngine(tt.init_params(cfg, device="cpu"), cfg, slots=2,
                         device="cpu", mesh=fake_mesh(tp=2))


def test_tp_engine_holds_local_heads_and_builds_no_graphs():
    """Under a tp=2 mesh the engine's cache, its block pool and its
    draft cache hold half the KV heads; no ``FusedBlockGraph`` is
    built."""
    eng = small_engine(chain_steps=2, draft_source="ngram", draft_len=2)
    assert eng.cache.k[0].shape[2] == S.FIELDS["n_kv_heads"] // 2
    assert eng._graphs is None
    paged = small_engine(kv_layout="paged", kv_block_size=4)
    assert paged.pool.k[0].shape[2] == S.FIELDS["n_kv_heads"] // 2
    cfg = tt.TransformerConfig(**S.port_cfg("step"))
    params = tt.init_params(cfg, device="cpu")
    drafted = small_engine(draft_params=params, draft_cfg=cfg)
    assert drafted._draft_cache.k[0].shape[2] == S.FIELDS["n_kv_heads"] // 2


# --------------------------------------------------------------------------
# mesh=None: the parent's ops
# --------------------------------------------------------------------------

#: sha256 of the op trace of :func:`torch_tp_serving.single_process_drain`
#: in each mode (and of ``single_process_entry_points``) and its op
#: count, recorded on the tree before the engine took ``mesh=``
PARENT_TRACE = {
    "step": (4808, "d45e77d2bda92c3f"),
    "chain4": (7520, "9d06e62e4e9eb9a3"),
    "chunk": (8485, "8cceea6c34fd8804"),
    "paged": (5356, "3ef7b3c18bf7482b"),
    "prefix": (5236, "3f148cc1d0020c4f"),
    "ngram": (4114, "40632af54259652b"),
    "ngram_fused": (6654, "2b5cd8458a156448"),
    "draft": (11159, "05fd7ea3ff611486"),
    "draft_fused": (16159, "6033ede9ea28d9cd"),
    "sampled": (4952, "e9bc7c4fa1bf6580"),
    "sampled_fused": (7264, "e5fa6f33a7069f36"),
    "quant": (4172, "4d1812f1bee65a70"),
    "lora": (5637, "a0694d205b336922"),
    "moe": (5582, "8ad22a7387bc598b"),
    "entry_points": (11272, "1f1707d2fde125ec"),
}


@pytest.mark.parametrize("mode", sorted(PARENT_TRACE))
def test_no_mesh_engine_runs_the_parent_ops(mode):
    trace = OpTrace()
    with trace:
        if mode == "entry_points":
            S.single_process_entry_points()
        else:
            S.single_process_drain(mode)
    digest = hashlib.sha256("\n".join(trace.ops).encode()).hexdigest()
    assert (len(trace.ops), digest[:16]) == PARENT_TRACE[mode]
