"""Spawned gloo process groups for the port's distributed tests
(test_torch_ring.py, test_torch_parallel.py, test_torch_tp.py,
test_torch_ep.py, test_torch_pipeline.py, test_torch_tp_decode.py,
test_torch_tp_decode_a0*.py, test_torch_tp_serving*.py).

:func:`run_group` starts ``world`` processes (spawn), each standing up
the default group through the port's ``rendezvous.initialize`` from the
driver's env contract (gloo, a port the OS picked), runs one worker
function of this module and saves its result; the parent joins them
with a deadline, kills what is left and raises on any failure, so a
deadlock fails one test instead of hanging the run.  The workers import
torch and the port only, never JAX: the tests compute JAX's references
in their own process and hand the workers numpy inputs.

Several checks run inside one group: a worker gets a list of cases and
returns one result per case, and :func:`jobs_worker` runs several
workers in turn.

The ``jax_*`` helpers at the end compute the JAX package's side of the
mesh cases in the test process; they import JAX inside, so the workers,
which import this module, never do.
"""

from __future__ import annotations

import multiprocessing as mp
import socket
import time
import traceback
from pathlib import Path

import numpy as np
import torch

#: seconds a spawned group may take, start to join
GROUP_TIMEOUT_S = 180
#: the process group's own timeout (every collective), well inside it
PG_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, out_dir):
    out = Path(out_dir)
    try:
        torch.set_num_threads(2)
        from k8s_dra_driver_tpu_torch.parallel import rendezvous
        env = {"TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "TPU_WORKER_ID": str(rank), "TPU_NUM_WORKERS": str(world),
               "TPU_RENDEZVOUS_BARRIER_TIMEOUT_S": str(PG_TIMEOUT_S)}
        rendezvous.initialize(rendezvous.spec_from_env(env),
                              backend="gloo")
        try:
            result = fn(rank, world, *args)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


class Group:
    """A spawned group in flight: :meth:`join` waits for it (deadline
    ``GROUP_TIMEOUT_S`` from the start) and returns the ranks' results
    in rank order, or raises with the failing ranks' tracebacks."""

    def __init__(self, fn, world: int, args, out_dir):
        self.world = world
        self.out = Path(out_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        ctx = mp.get_context("spawn")
        port = free_port()
        self.procs = [ctx.Process(target=_entry, args=(
            r, world, port, fn, args, str(self.out))) for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + GROUP_TIMEOUT_S

    def join(self) -> list:
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errs = {r: (self.out / f"rank{r}.err").read_text()
                for r in range(self.world)
                if (self.out / f"rank{r}.err").exists()}
        codes = [p.exitcode for p in self.procs]
        if hung or errs or any(codes):
            raise AssertionError(
                f"spawned group of {self.world} failed: hung ranks {hung}, "
                f"exit codes {codes}\n"
                + "\n".join(f"rank {r}:\n{e}" for r, e in errs.items()))
        return [torch.load(self.out / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


def run_group(fn, world: int, *args, out_dir) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks;
    returns the ranks' results in rank order."""
    return Group(fn, world, args, out_dir).join()


def shard(x, mesh):
    """This rank's shard of a global numpy array [B, T, ...]: batch rows
    by (dp, ep), the sequence by sp (``ProcessMesh.local_batch``)."""
    return mesh.local_batch(torch.from_numpy(np.ascontiguousarray(x)))


def unshard(parts: list, coords: list) -> np.ndarray:
    """The global array from the ranks' shards, each placed at its
    rank's ``coords`` ({"dp": i, "ep": j, "sp": k, ...}); the tp and pp
    copies of a shard must agree, and coordinate 0's is taken."""
    n = {a: 1 + max(c.get(a, 0) for c in coords) for a in ("dp", "ep", "sp")}
    grid = [[None] * n["sp"] for _ in range(n["dp"] * n["ep"])]
    for part, c in zip(parts, coords):
        row = c["dp"] * n["ep"] + c.get("ep", 0)
        if c.get("tp", 0) == 0 and c.get("pp", 0) == 0:
            grid[row][c["sp"]] = np.asarray(part)
    return np.concatenate([np.concatenate(row, axis=1) for row in grid],
                          axis=0)


# --------------------------------------------------------------------------
# Workers
# --------------------------------------------------------------------------

def attention_worker(rank, world, cases):
    """Ring or Ulysses attention on each case's mesh: this rank's output
    and the gradients of sum(out * g) in q, k and v."""
    from k8s_dra_driver_tpu_torch.ops.ring_attention import ring_attention
    from k8s_dra_driver_tpu_torch.ops.ulysses_attention import (
        ulysses_attention)
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    meshes, results = {}, []
    for c in cases:
        spec = MeshSpec(**c["spec"])
        if spec not in meshes:
            meshes[spec] = make_mesh(spec, device="cpu")
        mesh = meshes[spec]
        q, k, v = (shard(x, mesh).requires_grad_() for x in c["qkv"])
        g = shard(c["g"], mesh)
        seg = None if c["seg"] is None else shard(c["seg"], mesh)
        attend = (ulysses_attention if c["method"] == "ulysses"
                  else ring_attention)
        out = attend(q, k, v, mesh, causal=c["causal"],
                     window=c["window"], segment_ids=seg)
        (out * g).sum().backward()
        results.append(dict(coords=mesh.coords, out=out.detach().numpy(),
                            dq=q.grad.numpy(), dk=k.grad.numpy(),
                            dv=v.grad.numpy()))
    return results


def model_worker(rank, world, cases):
    """The transformer's mesh path on each case, on this rank's blocks of
    the case's (JAX) parameters (``shard_params``): ``forward`` logits of
    this rank's shard, or the losses of ``make_train_step`` steps on
    global batches (every rank the same batch), with the first step's
    summed gradients and the parameters after the steps gathered whole
    (``gather_params``)."""
    from k8s_dra_driver_tpu_torch.models import transformer as tt
    from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    meshes, results = {}, []
    for c in cases:
        spec = MeshSpec(**c["spec"])
        if spec not in meshes:
            meshes[spec] = make_mesh(spec, device="cpu")
        mesh = meshes[spec]
        cfg = tt.TransformerConfig(**c["cfg"])
        params = tt.shard_params(params_from_jax(c["params"], device="cpu"),
                                 cfg, mesh)
        seg = c.get("seg")
        if c["kind"] == "forward":
            with torch.no_grad():
                logits = tt.forward(params, shard(c["tokens"], mesh), cfg,
                                    None if seg is None
                                    else shard(seg, mesh), mesh=mesh)
            results.append(dict(coords=mesh.coords,
                                logits=logits.numpy()))
            continue
        step, _ = tt.make_train_step(cfg, device="cpu", mesh=mesh)
        leaves = [t.requires_grad_() for _, t in tt.named_tensors(params)]
        opt = tt.make_optimizer()(leaves)
        losses, grads = [], None
        for i, toks in enumerate(c["tokens"]):
            segs = None if seg is None else seg[i]
            params, opt, loss = step(params, opt, toks, segs)
            losses.append(float(loss))
            if grads is None:
                grads = tt.gather_params(tt.grad_tree(params), cfg, mesh)
        whole = tt.gather_params(params, cfg, mesh)
        moments = {id(t): opt.state[t]["exp_avg"] for t in leaves}
        results.append(dict(
            coords=mesh.coords, losses=losses,
            grads={n: t.numpy() for n, t in tt.named_tensors(grads)},
            params={n: t.numpy() for n, t in tt.named_tensors(whole)},
            blocks={n: (tuple(t.shape), tuple(moments[id(t)].shape))
                    for n, t in tt.named_tensors(params)}))
    return results


def a0_lora(cfg, lora: dict, device="cpu"):
    """An ``AdapterPool`` of ``lora["names"]`` (``make_adapter`` at
    ``lora["seeds"]``, rank ``lora["rank"]``), each acquired once in
    order: (the pool, their slots)."""
    from k8s_dra_driver_tpu_torch.serving_lora.pool import (
        AdapterManifest, AdapterPool, make_adapter)
    pool = AdapterPool(cfg, lora["rank"], len(lora["names"]), device=device)
    for name, seed in zip(lora["names"], lora["seeds"]):
        pool.register(AdapterManifest(
            name, lora["rank"], source=make_adapter(cfg, lora["rank"], seed)))
    return pool, [pool.acquire(name) for name in lora["names"]]


def tp_decode_worker(rank, world, cases):
    """Tensor-parallel decode on each case's mesh, on this rank's blocks
    of the case's (JAX) parameters: plain (``c["variant"]`` absent or
    ``"plain"``), or with what tensor-parallel decode once refused: the
    int8 KV cache (``"int8kv"``),
    ``shard_params(quantize_params(p))`` weights (``"quant"``), the
    paged pool read through K2's entry (``"paged"``: its plain version
    here), LoRA rows on this rank's cut of the pool's buffers
    (``"lora"``), an MoE config (``"moe"``).  Returns the logits of the
    prompt (``prefill``; the paged variant steps through it) and of
    steps fed the case's tokens, the greedy tokens of argmax steps (and
    of ``greedy_generate(mesh=)`` where it applies), the shapes of this
    rank's cache, scales, weights and adapter cut, and for ``"quant"``
    the weights ``gather_params`` puts back together."""
    from k8s_dra_driver_tpu_torch.models import decode as td
    from k8s_dra_driver_tpu_torch.models import transformer as tt
    from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
    from k8s_dra_driver_tpu_torch.models.quant import (QTensor,
                                                       quantize_params)
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from k8s_dra_driver_tpu_torch.serving_lora.pool import shard_lora_buffers
    meshes, results = {}, []
    for c in cases:
        spec = MeshSpec(**c["spec"])
        if spec not in meshes:
            meshes[spec] = make_mesh(spec, device="cpu")
        mesh = meshes[spec]
        cfg = tt.TransformerConfig(**c["cfg"])
        variant = c.get("variant", "plain")
        whole = params_from_jax(c["params"], device="cpu")
        if variant == "quant":
            whole = quantize_params(whole, cfg)
        params = tt.shard_params(whole, cfg, mesh)
        prompt = torch.from_numpy(c["prompt"]).long()
        forced = torch.from_numpy(c["forced"]).long()
        b, t = prompt.shape
        lora, out = None, dict(coords=mesh.coords)
        if variant == "lora":
            pool, slots = a0_lora(cfg, c["lora"])
            cut = shard_lora_buffers(pool.buffers, mesh)
            lora = (torch.tensor([0] + slots)[c["lora"]["rows"]], cut)
            out["lora_shapes"] = [tuple(a.shape) for a in cut[0]]
        with torch.no_grad():
            if variant == "paged":
                tables = torch.from_numpy(c["tables"])

                def fresh():
                    return td.init_paged_pool(cfg, c["n_blocks"], c["bs"],
                                              device="cpu", mesh=mesh)

                def step(pool, tok, i):
                    return td.paged_decode_step_rows(
                        params, tok[:, None], cfg, pool, tables,
                        torch.full((b,), i), use_kernel=True, mesh=mesh)

                pool, seen = fresh(), []
                for i in range(t + forced.shape[1]):
                    col = prompt[:, i] if i < t else forced[:, i - t]
                    lg, pool = step(pool, col, i)
                    seen.append(lg.numpy())
                out["prefill"] = np.stack(seen[:t], 1)
                out["steps"] = np.stack(seen[t:], 1)
                out["cache_shape"] = tuple(pool.k[0].shape)
                gpool = fresh()
                for i in range(t):
                    lg, gpool = step(gpool, prompt[:, i], i)
                tok, greedy = lg.argmax(-1), [lg.argmax(-1)]
                for i in range(t, t + c["n_new"] - 1):
                    lg, gpool = step(gpool, tok, i)
                    tok = lg.argmax(-1)
                    greedy.append(tok)
            else:
                cache = td.init_cache(cfg, b, device="cpu", mesh=mesh)
                logits, cache = td.prefill(params, prompt, cfg, cache,
                                           mesh=mesh)
                steps, pos = [], torch.full((b,), t)
                for i in range(forced.shape[1]):
                    lg, cache = td.decode_step_rows(
                        params, forced[:, i:i + 1], cfg, cache, pos,
                        lora=lora, mesh=mesh)
                    steps.append(lg.numpy())
                    pos = pos + 1
                out["prefill"] = logits.numpy()
                out["steps"] = np.stack(steps, 1)
                out["cache_shape"] = tuple(cache.k[0].shape)
                out["scale_shape"] = (None if cache.k_scale is None
                                      else tuple(cache.k_scale[0].shape))
                gcache = td.init_cache(cfg, b, device="cpu", mesh=mesh)
                lg, gcache = td.prefill(params, prompt, cfg, gcache,
                                        mesh=mesh)
                tok, pos = lg[:, -1].argmax(-1), torch.full((b,), t)
                greedy = [tok]
                for _ in range(c["n_new"] - 1):
                    lg, gcache = td.decode_step_rows(
                        params, tok[:, None], cfg, gcache, pos, lora=lora,
                        mesh=mesh)
                    tok, pos = lg.argmax(-1), pos + 1
                    greedy.append(tok)
                if variant != "lora":
                    out["generated"] = td.greedy_generate(
                        params, prompt, cfg, c["n_new"],
                        mesh=mesh)[:, t:].numpy()
        out["greedy"] = torch.stack(greedy, 1).numpy()
        out["leaf_shapes"] = {
            name: ((tuple(w.q.shape), tuple(w.scale.shape))
                   if isinstance(w, QTensor) else tuple(w.shape))
            for name, w in [("embed", params["embed"]),
                            ("unembed", params["unembed"])]
            + list(params["layers"][0].items())}
        if variant == "quant":
            back = tt.gather_params(params, cfg, mesh)
            out["gathered"] = {
                name: (w.q.numpy(), w.scale.numpy())
                for name, w in [("embed", back["embed"]),
                                ("unembed", back["unembed"])]
                + [(f"layers/{i}/{k}", v)
                   for i, layer in enumerate(back["layers"])
                   for k, v in layer.items() if isinstance(v, QTensor)]}
        results.append(out)
    return results


def _tp_serving_models(c, mesh):
    """(cfg, this rank's target blocks, draft keywords) of a serving
    case: ``params_from_jax`` of its weights, ``quantize_params`` first
    for int8 weights, ``shard_params`` under ``mesh`` (the whole weights
    without one); the draft model's blocks likewise."""
    from k8s_dra_driver_tpu_torch.models import transformer as tt
    from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    cfg = tt.TransformerConfig(**c["cfg"])
    whole = params_from_jax(c["weights"]["target"], device="cpu")
    if "quant" in c["extras"]:
        whole = quantize_params(whole, cfg)
    def blocks(tree, cfg_):
        return tree if mesh is None else tt.shard_params(tree, cfg_, mesh)

    kw = {}
    if "draft" in c["weights"]:
        dcfg = tt.TransformerConfig(**c["draft_cfg"])
        kw.update(draft_cfg=dcfg, draft_params=blocks(
            params_from_jax(c["weights"]["draft"], device="cpu"), dcfg))
    return cfg, blocks(whole, cfg), kw


def tp_serving_worker(rank, world, cases):
    """``ServingEngine(..., mesh=)`` on each case's mesh, on this rank's
    blocks of the case's (JAX) weights (int8 weights by
    ``shard_params(quantize_params(p))``, a draft model's blocks beside
    them, an ``AdapterPool`` of the case's adapters whose buffers the
    engine cuts): the case's requests drained.  Returns each request's
    stream, the engine's stats and dispatch labels, the KV heads of its
    cache (or pool) and of its draft cache, and whether it built a
    ``FusedBlockGraph``."""
    from k8s_dra_driver_tpu_torch.models.serving import (Request,
                                                         ServingEngine)
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from k8s_dra_driver_tpu_torch.serving_lora.pool import (
        AdapterManifest, AdapterPool, make_adapter)
    from k8s_dra_driver_tpu_torch.utils import dispatch
    meshes, results = {}, []
    for c in cases:
        spec = MeshSpec(**c["spec"])
        if spec not in meshes:
            meshes[spec] = make_mesh(spec, device="cpu")
        mesh = meshes[spec]
        cfg, params, kw = _tp_serving_models(c, mesh)
        kw.update(c["engine"])
        if "lora" in c["extras"]:
            lo = c["lora"]
            pool = AdapterPool(cfg, lo["rank"], len(lo["names"]),
                               device="cpu")
            for name, seed in zip(lo["names"], lo["seeds"]):
                pool.register(AdapterManifest(name, lo["rank"],
                                              source=make_adapter(
                                                  cfg, lo["rank"], seed,
                                                  lo["scale"])))
            kw["adapter_pool"] = pool
        eng = ServingEngine(params, cfg, slots=c["slots"], device="cpu",
                            mesh=mesh, **kw)
        for r in c["requests"]:
            eng.submit(Request(**r))
        with dispatch.track() as t:
            done = eng.run()
        kv = eng.pool if eng.cache is None else eng.cache
        results.append(dict(
            coords=mesh.coords, streams={f.uid: f.tokens for f in done},
            stats=eng.stats(), by_label=dict(t.by_label),
            kv_heads=kv.k[0].shape[2],
            draft_kv_heads=(None if eng._draft_cache is None
                            else eng._draft_cache.k[0].shape[2]),
            graphs=eng._graphs is not None))
    return results


def tp_rows_worker(rank, world, cases):
    """The row functions and entry points a tensor-parallel engine runs,
    on each case's mesh and this rank's blocks: a fresh fill of the
    case's prompts into slots (``prefill_adopt_rows``), a prefix-hit
    fill of a suffix (``suffix_fill_adopt``), a window of forced tokens
    scored (``decode_window_rows``), greedy and sampled draft proposals
    (``draft_propose_rows``, ``draft_sample_rows``) and the target's
    accept-side distributions over the sampled ones, a fused block
    (``decode_fused_rows``) beside the same steps one at a time
    (``decode_step_rows`` then ``sample_rows``), a fused speculative
    block of each source (``decode_spec_fused_rows``), and
    ``speculative_generate``, ``ngram_speculative_generate`` and
    ``sample_generate`` (at ``top_k`` 1 and the case's).  Returns the
    first tokens, the slots' filled K/V of this rank's heads, the window
    logits, the proposals with their draft and target distributions,
    the blocks' packed outputs and the entry points' tokens."""
    from k8s_dra_driver_tpu_torch.models import decode as td
    from k8s_dra_driver_tpu_torch.models import speculative as tsp
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    meshes, results = {}, []
    for c in cases:
        spec = MeshSpec(**c["spec"])
        if spec not in meshes:
            meshes[spec] = make_mesh(spec, device="cpu")
        mesh = meshes[spec]
        with torch.no_grad():
            results.append(_tp_rows(td, tsp, c, mesh))
    return results


def _tp_rows(td, tsp, c, mesh) -> dict:
    cfg, params, kw = _tp_serving_models(c, mesh)
    dcfg, draft = kw["draft_cfg"], kw["draft_params"]
    prompts = torch.from_numpy(c["prompts"]).long()
    b, t = prompts.shape
    slots, s = c["slots"], cfg.max_seq
    out = dict(coords=None if mesh is None else mesh.coords)

    def gens(seed):
        return [torch.Generator().manual_seed(seed + i) for i in range(b)]

    cache = td.init_cache(cfg, slots, s, device="cpu", mesh=mesh)
    first, cache = td.prefill_adopt_rows(
        params, prompts, cfg, cache, c["slot_ids"], [None] * b, [0.0] * b,
        mesh=mesh)
    out["fill_first"] = first.numpy()
    # copies: the prefix-hit fill below writes the same cache in place
    out["fill_kv"] = [a[:, :t].numpy().copy() for a in cache.k + cache.v]
    p = c["prefix_len"]
    entry = td.init_cache(cfg, 1, s, device="cpu", mesh=mesh)
    _, entry = td.prefill(params, prompts[:1, :p], cfg, entry, mesh=mesh)
    tok, cache, _ = td.suffix_fill_adopt(
        params, entry, prompts[0, p:], cfg, cache, c["hit_slot"], None, 0.0,
        mesh=mesh)
    out["hit_first"] = int(tok)
    out["hit_kv"] = [a[c["hit_slot"], :t].numpy()
                     for a in cache.k + cache.v]
    pos = torch.full((b,), t)
    window = torch.from_numpy(c["window"]).long()
    wcache = td.init_cache(cfg, b, s, device="cpu", mesh=mesh)
    _, wcache = td.prefill(params, prompts, cfg, wcache, mesh=mesh)
    logits, _ = td.decode_window_rows(params, window, cfg, wcache, pos,
                                      mesh=mesh)
    out["window_logits"] = logits.numpy()
    last = window[:, 0]
    dcache = td.init_cache(dcfg, b, s, device="cpu", mesh=mesh)
    td.prefill(draft, prompts, dcfg, dcache, mesh=mesh)
    props, _ = td.draft_propose_rows(draft, last, dcfg, dcache, pos,
                                     c["draft_len"], mesh=mesh)
    out["draft_greedy"] = props.numpy()
    temps = torch.tensor(c["temps"], dtype=torch.float32)
    props, q, _ = td.draft_sample_rows(
        draft, last, dcfg, dcache, pos, c["draft_len"], gens(7), temps,
        c["top_k"], mesh=mesh)
    out["draft_sampled"], out["draft_q"] = props.numpy(), q.numpy()
    # the target's accept-side distributions over the sampled proposals
    # (the window overwrites the forced window's rows at the same
    # offsets)
    logits, _ = td.decode_window_rows(
        params, torch.cat([last[:, None], props], dim=1), cfg, wcache, pos,
        mesh=mesh)
    out["accept_p"] = td._target_probs(logits, temps, c["top_k"],
                                       0.0).numpy()
    out.update(_tp_blocks(td, c, cfg, params, dcfg, draft, prompts, mesh))
    n = c["n_new"]
    out["speculative"] = [x if isinstance(x, int) else x.numpy()
                          for x in tsp.speculative_generate(
                              params, draft, prompts, cfg, dcfg, n,
                              draft_len=c["draft_len"], mesh=mesh)]
    out["ngram"] = [x if isinstance(x, int) else x.numpy()
                    for x in tsp.ngram_speculative_generate(
                        params, prompts, cfg, n, draft_len=c["draft_len"],
                        mesh=mesh)]
    out["sample_top1"] = td.sample_generate(
        params, prompts, cfg, n, torch.Generator().manual_seed(5), top_k=1,
        mesh=mesh).numpy()
    out["sample"] = td.sample_generate(
        params, prompts, cfg, n, torch.Generator().manual_seed(5),
        top_k=c["top_k"], mesh=mesh).numpy()
    return out


def _tp_blocks(td, c, cfg, params, dcfg, draft, prompts, mesh) -> dict:
    """The fused block against the same steps one at a time, and the
    fused speculative block of each source, from a fresh prefill of
    ``prompts`` (greedy rows and the case's sampled ones)."""
    b, t = prompts.shape
    k, s = c["block"], cfg.max_seq
    temps = torch.tensor(c["temps"], dtype=torch.float32)
    budget = torch.tensor(c["budget"])
    eos = torch.full((b,), -1)
    out = {}

    def filled(cfg_, params_):
        cache = td.init_cache(cfg_, b, s, device="cpu", mesh=mesh)
        logits, cache = td.prefill(params_, prompts, cfg_, cache, mesh=mesh)
        return logits[:, -1].argmax(-1), cache

    def gens(seed):
        return [torch.Generator().manual_seed(seed + i) for i in range(b)]

    last, cache = filled(cfg, params)
    packed, done, _ = td.decode_fused_rows(
        params, last, cfg, cache, torch.full((b,), t), k, gens(11), temps,
        budget, eos, c["top_k"], mesh=mesh)
    out["fused"], out["fused_done"] = packed.numpy(), int(done)
    last, cache = filled(cfg, params)
    g, pos, steps = gens(11), torch.full((b,), t), []
    for _ in range(k):
        logits, cache = td.decode_step_rows(params, last[:, None], cfg, cache,
                                            pos, mesh=mesh)
        last = td.sample_rows(logits, g, temps, c["top_k"])
        steps.append(last.numpy())
        pos = pos + 1
    out["stepped"] = np.stack(steps, 1)
    ctx = prompts.int()
    ctx_len = torch.full((b,), t, dtype=torch.int32)
    for name, dp in (("spec_ngram", None), ("spec_draft", draft)):
        last, cache = filled(cfg, params)
        dcache = None
        if dp is not None:
            _, dcache = filled(dcfg, dp)
        packed, done, _ = td.decode_spec_fused_rows(
            params, last, cfg, cache, torch.full((b,), t), k, gens(11),
            temps, budget, eos, ctx, ctx_len, dp,
            dcfg if dp is not None else None, dcache,
            gens(21) if dp is not None else None, c["draft_len"], c["top_k"],
            mesh=mesh)
        out[name], out[name + "_done"] = packed.numpy(), int(done)
    return out


def mlp_stage(params, x):
    """Two chained residual MLP layers a stage (tests/test_pipeline.py's
    stage body)."""
    for w1, w2 in zip(params["w1"], params["w2"]):
        x = x + torch.tanh(x @ w1) @ w2
    return x


def pipeline_worker(rank, world, cases):
    """``pipeline_apply`` of :func:`mlp_stage` on each case's mesh: the
    output, and the gradients of sum(out * wgt) in x and in the stacked
    stage parameters (this rank's stage's rows nonzero)."""
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from k8s_dra_driver_tpu_torch.parallel.pipeline import pipeline_apply
    meshes, results = {}, []
    for c in cases:
        spec = MeshSpec(**c["spec"])
        if spec not in meshes:
            meshes[spec] = make_mesh(spec, device="cpu")
        mesh = meshes[spec]
        stacked = {k: torch.from_numpy(v).requires_grad_()
                   for k, v in c["stages"].items()}
        x = torch.from_numpy(c["x"]).requires_grad_()
        out = pipeline_apply(mlp_stage, stacked, x, mesh=mesh,
                             n_microbatches=c["m"],
                             checkpoint_stages=c["checkpoint"])
        (out * torch.from_numpy(c["wgt"])).sum().backward()
        results.append(dict(
            coords=mesh.coords, out=out.detach().numpy(),
            dx=x.grad.numpy(),
            grads={k: v.grad.numpy() for k, v in stacked.items()}))
    return results


def contract_worker(rank, world):
    """The rendezvous' liveness psum, what ``make_mesh`` refuses on this
    group ((exception type, message), or None), and, for the tp, ep and
    pp meshes and one of every axis the group can hold, this rank's
    coordinates, its line along each axis and a sum over each line."""
    from k8s_dra_driver_tpu_torch.parallel import rendezvous
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    out = {"psum": rendezvous.gang_psum(float(rank + 1))}
    try:
        make_mesh(MeshSpec(dp=world + 1), device="cpu")
        out["mismatch"] = None
    except Exception as e:    # recorded for the test to judge
        out["mismatch"] = (type(e).__name__, str(e))
    specs = {"tp": MeshSpec(tp=world), "ep": MeshSpec(ep=world),
             "pp": MeshSpec(pp=world)}
    if world == 4:
        specs["tp_pp"] = MeshSpec(tp=2, pp=2)
        specs["dp_ep"] = MeshSpec(dp=2, ep=2)
    out["meshes"] = {}
    for name, spec in specs.items():
        mesh = make_mesh(spec, device="cpu")
        sums = {}
        for axis, n in spec.axis_sizes().items():
            if n > 1:
                x = torch.tensor([float(rank)])
                sums[axis] = float(mesh.all_reduce_(x, axis))
        out["meshes"][name] = (spec.axis_sizes(), mesh.coords,
                               {a: mesh.line(a) for a in sums}, sums)
    mesh = make_mesh(device="cpu")
    out["default"] = (mesh.spec.axis_sizes(), mesh.coords)
    return out


def timeout_worker(rank, world, spec: dict):
    """The deadline of a ``make_mesh`` mesh of ``spec`` after
    ``rendezvous.initialize`` and the gloo timeout of each of its axis
    groups, in seconds (``mesh``); and the rendezvous' own record."""
    from k8s_dra_driver_tpu_torch.parallel import rendezvous
    from k8s_dra_driver_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    return dict(
        recorded=rendezvous.group_timeout().total_seconds(),
        mesh=dict(
            mesh=mesh.timeout.total_seconds(),
            groups={axis: mesh.group(axis)._get_backend(
                torch.device("cpu")).options._timeout.total_seconds()
                for axis, n in mesh.spec.axis_sizes().items() if n > 1}))


def jobs_worker(rank, world, jobs):
    """``[(worker, args), ...]`` run in turn on one group."""
    return [fn(rank, world, *args) for fn, args in jobs]


def as_global_worker(rank, world, batch):
    """``models/data.as_global`` over a dp mesh of the world: each rank
    hands in its ``local_rows`` stripe of ``batch`` and gets the global
    batch back."""
    from k8s_dra_driver_tpu_torch.models.data import as_global, local_rows
    from k8s_dra_driver_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(device="cpu")
    return as_global(local_rows(batch), mesh).numpy()


# --------------------------------------------------------------------------
# The JAX side of the mesh cases (test process only)
# --------------------------------------------------------------------------

def jax_mesh(world, spec: dict):
    import jax

    from k8s_dra_driver_tpu.parallel.mesh import MeshSpec, make_mesh
    return make_mesh(MeshSpec(**spec), devices=jax.devices()[:world])


def jax_forward(jcfg, params, tokens, world, spec, seg=None) -> np.ndarray:
    """JAX's ``forward`` of numpy ``params`` on the virtual mesh."""
    import jax
    import jax.numpy as jnp

    from k8s_dra_driver_tpu.models import transformer as jt
    mesh = jax_mesh(world, spec)
    placed = jt.shard_params(jax.tree.map(jnp.asarray, params), jcfg, mesh)
    fn = jax.jit(lambda p, t, s: jt.forward(p, t, jcfg, mesh,
                                            segment_ids=s))
    return np.asarray(fn(placed, jnp.asarray(tokens),
                         None if seg is None else jnp.asarray(seg)))


def jax_tp_decode(jcfg, params, prompt, forced, n_new, world=None,
                  spec=None, *, quant=False, lora=None, paged=None,
                  logits=True, greedy=True):
    """The JAX package's decode on numpy ``params`` (plain, or one of
    what tensor-parallel decode once refused), placed by
    ``shard_params`` on the virtual mesh when ``world`` is given
    (GSPMD splits them; caches, pools and adapter buffers stay whole),
    on one device otherwise.  ``quant``: int8 weights, the JAX
    order ``quantize_params(shard_params(p))``; ``lora``: ``(slots [B],
    whole buffers)``; ``paged``: ``(n_blocks, block_size, tables)``,
    every token (the prompt's too) through ``paged_decode_step_rows``
    with the dense-gather read.  Returns ``(prompt logits [B, T, V],
    logits of steps fed ``forced`` [B, N, V], greedy tokens [B,
    n_new])``; the logits are None without ``logits``, the tokens
    without ``greedy``."""
    import jax
    import jax.numpy as jnp

    from k8s_dra_driver_tpu.models import decode as jd
    from k8s_dra_driver_tpu.models import transformer as jt
    from k8s_dra_driver_tpu.models.quant import quantize_params
    placed = jax.tree.map(jnp.asarray, params)
    if world is not None:
        placed = jt.shard_params(placed, jcfg, jax_mesh(world, spec))
    if quant:
        placed = jax.jit(lambda p: quantize_params(p, jcfg))(placed)
    if lora is not None:
        lora = (jnp.asarray(lora[0], jnp.int32),
                jax.tree.map(jnp.asarray, lora[1]))
    b, t = prompt.shape
    prompt, forced = jnp.asarray(prompt), jnp.asarray(forced)

    if paged is not None:
        n_blocks, bs, tables = paged
        tables = jnp.asarray(tables)

        def step(state, tok, i):
            return jd.paged_decode_step_rows(
                placed, tok[:, None], jcfg, state, tables,
                jnp.full((b,), i, jnp.int32), use_kernel=False, lora=lora)

        def start():
            state, seen = jd.init_paged_pool(jcfg, n_blocks, bs), []
            for i in range(t):
                lg, state = step(state, prompt[:, i], i)
                seen.append(np.asarray(lg))
            return state, np.stack(seen, 1), lg
    else:
        def step(state, tok, i):
            return jd.decode_step_rows(placed, tok[:, None], jcfg, state,
                                       jnp.full((b,), i, jnp.int32), lora)

        def start():
            lg, state = jd.prefill(placed, prompt, jcfg,
                                   jd.init_cache(jcfg, b))
            return state, np.asarray(lg), lg[:, -1]

    first = steps = tokens = None
    if logits:
        state, first, _ = start()
        seen = []
        for i in range(forced.shape[1]):
            lg, state = step(state, forced[:, i], t + i)
            seen.append(np.asarray(lg))
        steps = np.stack(seen, 1)
    if greedy:
        state, _, lg = start()
        tok = lg.argmax(-1)
        seen = [tok]
        for i in range(t, t + n_new - 1):
            lg, state = step(state, tok, i)
            tok = lg.argmax(-1)
            seen.append(tok)
        tokens = np.asarray(jnp.stack(seen, 1))
    return first, steps, tokens


def jax_train(jcfg, world, spec, batches, seed=2, segs=None):
    """JAX's ``make_train_step`` on the virtual mesh from
    ``init_state(PRNGKey(seed))``: the initial parameters (numpy, in
    JAX's layout: staged for a pp config) at once, and ``finish()``,
    which computes the gradient of the first batch's loss at them, the
    losses of a step a batch and the final parameters (both trees by
    ``named_tensors`` name) — to run while the port's group runs."""
    import jax
    import jax.numpy as jnp

    from k8s_dra_driver_tpu.models import transformer as jt
    from k8s_dra_driver_tpu_torch.models.transformer import named_tensors
    mesh = jax_mesh(world, spec)
    step, init_state = jt.make_train_step(jcfg, mesh)
    params, opt = init_state(jax.random.PRNGKey(seed))
    init = jax.tree.map(np.array, params)

    def finish() -> dict:
        nonlocal params, opt
        seg0 = None if segs is None else jnp.asarray(segs[0])
        grads = jax.jit(jax.grad(lambda p, t, s: jt.loss_fn(
            p, t, jcfg, mesh, s)))(params, jnp.asarray(batches[0]), seg0)
        grads = dict(named_tensors(jax.tree.map(np.asarray, grads)))
        losses = []
        for i, toks in enumerate(batches):
            seg = None if segs is None else jnp.asarray(segs[i])
            params, opt, loss = step(params, opt, jnp.asarray(toks), seg)
            losses.append(float(loss))
        return dict(params=init, grads=grads, losses=losses,
                    final=dict(named_tensors(jax.tree.map(np.asarray,
                                                          params))))

    return init, finish
