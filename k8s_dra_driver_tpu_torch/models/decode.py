"""Autoregressive decoding with a KV cache: contiguous and paged.

The port of ``k8s_dra_driver_tpu/models/decode.py`` (dense and MoE
models, full-precision or int8 weights, model-dtype or int8 cache).
Serving runs prefill + one-token decode steps against a per-layer K/V
cache:

- **Contiguous cache**: per layer ``[B, max_seq, H_kv, D]``; writes
  land at each row's position and attention masks ``key_pos <=
  query_pos`` (``_cached_attention``), exactly the reference's math:
  f32 scores, -1e30 masking, f32 softmax, GQA kept grouped (query
  head h = kvh * G + g, the kernels' convention).
- **Paged cache**: per layer ``[n_blocks, block_size, H_kv, D]``
  pools read through per-row block tables.  On the card the decode
  read goes through the paged kernel (K2, ops/paged_attention.py);
  otherwise the blocks are gathered into the contiguous cache's exact
  shape and fed to the SAME ``_cached_attention``, which keeps the
  paged engine bitwise equal to the contiguous one on the CPU.
- **Fresh prefill** (``first_chunk``) attends the chunk's own K/V
  through the flash kernel (K1, ops/flash_attention.py) on the card.
- **int8 cache** (``kv_cache_dtype="int8"``, contiguous only): k/v are
  stored as int8 with one symmetric f32 scale per (row, position, KV
  head), quantized at write (``_quantize_rows``) and dequantized at
  read in ``_cached_attention``; a fresh prefill's own K/V stay
  unquantized for the flash kernel, only cached entries round-trip
  through int8.  The paged pool refuses it, as the JAX package's does.

Where the JAX package donated a buffer and got a new one back, the
port writes in place: the cache and pool tensors passed in are
updated and returned.  Callers that must keep a tensor intact (prefix
entries) clone it first; each such place says so.

Sampling: ``jax.random`` streams cannot be reproduced, so sampled
draws use ``torch.Generator``s (one per slot in the engine, reseeded
with each request's seed at its fill): the same seed gives the same
tokens whatever the batch or schedule.  ``_filter_logits`` is
deterministic and matches the reference exactly.

**Fused generation block** (``decode_fused_rows``): up to k per-row
decode steps with sampling, KV writes and per-row EOS / budget stops
on the device, one step body for both forms: a loop with an early
exit (the CPU path) and, on the card, one captured CUDA graph per
block length (``FusedBlockGraph``), replayed once per block.

**Speculative decoding**: a draft source (the draft model's greedy or
sampled k+1-step loop, ``draft_propose_rows`` / ``draft_sample_rows``,
or the prompt n-gram lookup, ``draft_ngram_rows``) proposes
``draft_len`` tokens a row, one target forward scores the window
(``decode_window_rows``, ``paged_window_rows``) and
``spec_accept_rows`` keeps each row's accepted prefix plus a
correction (exact match for greedy rows, rejection sampling for
sampled ones).  ``decode_spec_fused_rows`` runs up to k windows a
block, on the card as a ``FusedBlockGraph`` with a ``SpecDraft``.

**Tensor parallelism** (``mesh=`` on every row function a serving
engine calls: the contiguous path's :func:`init_cache`,
:func:`forward_with_cache`, :func:`prefill`, :func:`decode_step`,
:func:`decode_step_rows`; the paged one's :func:`init_paged_pool`,
:func:`paged_decode_step_rows`, :func:`paged_window_rows`; the window
and draft rows :func:`decode_window_rows`, :func:`draft_propose_rows`,
:func:`draft_sample_rows`; the fills :func:`prefill_adopt_rows`,
:func:`suffix_fill_adopt`; the fused blocks :func:`decode_fused_rows`,
:func:`decode_spec_fused_rows`; and :func:`greedy_generate`,
:func:`sample_generate`): over a ``parallel.mesh.ProcessMesh`` whose
tp axis is > 1, each rank holds its blocks of the weights
(``transformer.shard_params``, int8 ``QTensor`` weights too) and a
cache or block pool of its ``H_kv/tp`` KV heads (with their int8
scales under ``kv_cache_dtype="int8"``).  The embedding is
``transformer._embed`` (this rank's d-slice, all-gathered); wq/wk/wv
project this rank's heads from the replicated input, the fresh prefill
runs K1 and the paged step K2 on them, and wo's partial output is
summed over tp (``reduce_from``); the MLP is ``transformer._dense_mlp``
(an MoE layer's ``transformer._moe_mlp_replicated``: this rank's
``E/ep`` experts and ``d_ff/tp`` hidden units, summed over tp and ep)
and the logits ``transformer._unembed``, whole on every tp rank, so
every rank takes the same argmax and, from generators seeded alike,
draws the same samples.  LoRA rows take this rank's cut of the adapter
buffers (``serving_lora.pool.shard_lora_buffers``): the wq delta of
its heads, the wo delta summed with wo's partial output.  The other
axes replicate the batch and the cache, as GSPMD does with the JAX
package's unsharded cache.  Under a mesh the fused blocks run step by
step, the host reading ``done`` between steps (the JAX block's
``lax.while_loop`` exit), and are never captured as a
:class:`FusedBlockGraph`: gloo's host-staged collectives cannot be
recorded in a CUDA graph.  pp-staged params under tp > 1 raise
``NotImplementedError`` (:func:`_refuse_tp`); with ``mesh=None`` every
op is the single-process path's.

Parity contract (tests/test_torch_decode.py): prefill + stepwise
decode logits equal the training forward at every position, and equal
the JAX package's within the stated f32 tolerance; under tp
(tests/test_torch_tp_decode.py) they equal the JAX package's decode
on its GSPMD-sharded weights.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_attention
from ..parallel.mesh import reduce_from, spec_block
from ..utils import dispatch
from . import quant
from .quant import QTensor, ein
from .transformer import (Params, TransformerConfig, _dense_mlp, _embed,
                          _moe_mlp, _moe_mlp_replicated, _unembed,
                          param_specs, rms_norm, rotary, unstage_params)

_NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def _serving_cfg(cfg: TransformerConfig) -> TransformerConfig:
    """Serving always runs the exact dense MoE dispatch: capacity's
    token drops restart with every chunk's cumsum, so chunked prefill
    and stepwise decode would drop other tokens than the training
    forward; dense dispatch is drop-free and chunk-invariant.  (gmm is
    dropless too, but its static row bound pads every expert to a
    block for a one-token decode step.)"""
    if cfg.is_moe and cfg.moe_dispatch != "dense":
        return dataclasses.replace(cfg, moe_dispatch="dense")
    return cfg


@dataclasses.dataclass
class KVCache:
    """Per-layer K/V tensors [B, S, H_kv, D] + the tokens cached so far
    (``pos``; meaningless for a multi-slot engine cache, where each
    row keeps its own position host-side, and for a block pool).

    With ``kv_cache_dtype="int8"`` k/v are int8 and ``k_scale`` /
    ``v_scale`` hold one f32 scale per (row, position, KV head),
    [B, S, H_kv, 1]; otherwise the scale lists are None."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    pos: int = 0
    k_scale: list[torch.Tensor] | None = None
    v_scale: list[torch.Tensor] | None = None

    def tensors(self) -> list[torch.Tensor]:
        """Every per-layer tensor, in a fixed order: k, v, then the
        scales when the cache is int8."""
        return (self.k + self.v + (self.k_scale or [])
                + (self.v_scale or []))


def copy_cache(cache: KVCache, pos: int) -> KVCache:
    """A copy of ``cache`` that owns its tensors (scales included),
    with ``pos`` valid rows: what a prefix hit prefills into while the
    remembered entry stays intact."""
    def dup(lst):
        return None if lst is None else [a.clone() for a in lst]

    return KVCache(k=dup(cache.k), v=dup(cache.v), pos=int(pos),
                   k_scale=dup(cache.k_scale), v_scale=dup(cache.v_scale))


def _with_layers(params: Params, cfg: TransformerConfig) -> Params:
    """Accept the pp staged layout wherever decoding iterates the layers
    (JAX's ``decode.py:278``): serving runs on one device, so staged
    params are unstaged (views, no copy)."""
    if "stages" in params:
        return unstage_params(params, cfg)
    return params


def _device(params: Params) -> torch.device:
    return params["embed"].device


#: ROADMAP's item that names what decode and serving keep on one
#: process under tensor parallelism
_TP_LATER = "ROADMAP Queue A, item A3"


def _tp(mesh) -> bool:
    """Whether ``mesh`` splits the heads: a mesh whose tp axis is > 1."""
    return mesh is not None and mesh.size("tp") > 1


def _refuse_tp(cfg: TransformerConfig, mesh, params: Params | None = None
               ) -> None:
    """Raise ``NotImplementedError`` for pp-staged params under tp > 1:
    the JAX package's decode unstages them onto one device."""
    if _tp(mesh) and (cfg.pp_stages > 1
                      or (params is not None and "stages" in params)):
        _tp_later("pp-staged params")


def _tp_later(what: str) -> None:
    raise NotImplementedError(
        f"decode under tensor parallelism (tp > 1) does not carry {what} "
        f"({_TP_LATER})")


def _local_kv_heads(cfg: TransformerConfig, mesh) -> int:
    """This rank's KV heads under ``mesh``: the block of wk's head axis
    its tp coordinate holds (``H_kv/tp``; all of them without tp).  A
    config whose query or KV heads do not divide by tp is refused in
    the words of ``transformer.shard_params``."""
    if not _tp(mesh):
        return cfg.kv_heads
    specs = param_specs(cfg)["layers"][0]
    sizes, coords = mesh.spec.axis_sizes(), mesh.coords
    spec_block((cfg.d_model, cfg.n_heads, cfg.d_head), specs["wq"], sizes,
               coords)
    lo, hi = spec_block((cfg.d_model, cfg.kv_heads, cfg.d_head),
                        specs["wk"], sizes, coords)[1]
    return hi - lo


def init_cache(cfg: TransformerConfig, batch: int,
               max_seq: int | None = None, device="cuda",
               mesh=None) -> KVCache:
    """Zero cache of ``batch`` rows by ``max_seq`` positions (int8 k/v
    with f32 [B, S, H_kv, 1] scales under ``kv_cache_dtype="int8"``).
    Under a ``mesh`` whose tp axis is > 1 the cache (and its scales)
    holds this rank's ``H_kv/tp`` KV heads: quantization is per (row,
    position, head), so each rank quantizes its own heads."""
    _refuse_tp(cfg, mesh)
    max_seq = max_seq or cfg.max_seq
    h_kv = _local_kv_heads(cfg, mesh)
    shape = (batch, max_seq, h_kv, cfg.d_head)

    def zeros(shp, dtype):
        return [torch.zeros(shp, dtype=dtype, device=device)
                for _ in range(cfg.n_layers)]

    if cfg.kv_cache_dtype == "int8":
        sshape = (batch, max_seq, h_kv, 1)
        return KVCache(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                       pos=0, k_scale=zeros(sshape, torch.float32),
                       v_scale=zeros(sshape, torch.float32))
    return KVCache(k=zeros(shape, cfg.dtype), v=zeros(shape, cfg.dtype),
                   pos=0)


def _quantize_rows(x):
    """[B, T, H, D] -> (int8 values, f32 scale [B, T, H, 1]):
    symmetric per-(token, head) quantization over the head dim."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True),
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _cached_attention(q, k_cache, v_cache, pos, t, cfg, k_scale=None,
                      v_scale=None):
    """q [B,T,H,D] at absolute positions pos..pos+T-1 (``pos`` an int,
    or a [B] tensor of per-row positions) against the full cache
    [B,S,H_kv,D]; causal trim via position mask.  GQA stays grouped:
    q is reshaped to [B,T,H_kv,G,D] and the un-repeated cache is read
    once.  With scales (int8 cache) the entries are dequantized at
    read, ``k = k_q * k_scale`` in f32, then cast to q's dtype."""
    if k_scale is not None:
        k_cache = (k_cache.float() * k_scale).to(q.dtype)
        v_cache = (v_cache.float() * v_scale).to(q.dtype)
    b, _, h, dh = q.shape
    h_kv = k_cache.shape[2]
    group = h // h_kv
    scale = cfg.d_head ** -0.5
    dev = q.device
    key_pos = torch.arange(k_cache.shape[1], device=dev)
    steps = torch.arange(t, device=dev)
    if isinstance(pos, int):
        q_pos = (pos + steps)[None]                     # [1, T] shared
    else:
        q_pos = pos[:, None] + steps[None]              # [B, T]
    mask = key_pos[None, None, :] <= q_pos[:, :, None]  # [1|B, T, S]
    if cfg.attention_window:
        mask &= (q_pos[:, :, None] - key_pos[None, None, :]) < \
            cfg.attention_window
    if group == 1:
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k_cache.float()) * scale
        scores = scores.masked_fill(~mask[:, None], _NEG_INF)
        p = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p,
                            v_cache.float()).to(q.dtype)
    qg = q.reshape(b, t, h_kv, group, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k_cache.float()) * scale
    scores = scores.masked_fill(~mask[:, None, None], _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return out.reshape(b, t, h, dh).to(q.dtype)


def _project_and_write(layer, x, positions, cfg, k_cache, v_cache,
                       ks_cache, vs_cache, write, lora=None):
    """Shared per-layer front half of cached decoding: q/k/v
    projections + RoPE at ``positions`` ([T] shared or [B,T] per-row),
    int8 quantization when the cache has scales (``ks_cache`` not
    None), and the cache writes through ``write(dst, new)`` — the only
    part that differs between the aligned, per-row and paged paths.

    ``lora`` is one layer's slice of the per-row adapter gather
    (serving_lora/): ``(slots [B] long, aq [S,d,r], bq [S,r,H,K], ao,
    bo)``.  Each row adds its adapter's low-rank wq delta ``(h@A)@B``
    before RoPE, the factors gathered from the pooled buffers by slot
    id; slot 0 is the null adapter (zero factors), so a base row adds
    an exact zero.  K/V carry no adapter: prompt K/V and prefix sharing
    stay adapter-independent."""
    h = rms_norm(x, layer["ln1"])
    q_raw = ein("btd,dhk->bthk", h, layer["wq"])
    if lora is not None:
        slots, aq, bq = lora[0], lora[1], lora[2]
        q_raw = q_raw + torch.einsum(
            "btr,brhk->bthk", torch.einsum("btd,bdr->btr", h, aq[slots]),
            bq[slots])
    q = rotary(q_raw, positions, cfg.rope_theta)
    k = rotary(ein("btd,dhk->bthk", h, layer["wk"]), positions,
               cfg.rope_theta)
    v = ein("btd,dhk->bthk", h, layer["wv"])
    if ks_cache is not None:
        kq, ks = _quantize_rows(k)
        vq, vs = _quantize_rows(v)
        write(k_cache, kq)
        write(v_cache, vq)
        write(ks_cache, ks)
        write(vs_cache, vs)
    else:
        write(k_cache, k)
        write(v_cache, v)
    return q, k, v


def _attn_mlp_tail(x, o, layer, cfg, lora=None, mesh=None):
    """Shared per-layer back half: attention output projection +
    residual + MLP (dense, or MoE under the serving config).  ``lora``
    adds each row's wo delta ``(o@A)@B`` to the projection (the gather
    of :func:`_project_and_write`).  Under tp (``mesh``) the projection
    of this rank's heads, its LoRA delta included, is summed over tp
    and the MLP runs on its ``d_ff/tp`` hidden units; an MoE layer under
    any mesh runs this rank's experts, summed over tp and ep
    (``transformer._moe_mlp_replicated``).  Without a mesh none of it
    adds an op."""
    proj = ein("bthk,hkd->btd", o, layer["wo"])
    if lora is not None:
        slots, ao, bo = lora[0], lora[3], lora[4]
        proj = proj + torch.einsum(
            "btr,brd->btd", torch.einsum("bthk,bhkr->btr", o, ao[slots]),
            bo[slots])
    x = x + reduce_from(proj, mesh, "tp")
    mlp_in = rms_norm(x, layer["ln2"])
    if cfg.is_moe and mesh is not None:
        return x + _moe_mlp_replicated(mlp_in, layer, _serving_cfg(cfg),
                                       mesh)
    if cfg.is_moe:
        return x + _moe_mlp(mlp_in, layer, _serving_cfg(cfg))
    return x + _dense_mlp(mlp_in, layer, mesh)


def forward_with_cache(params: Params, tokens: torch.Tensor,
                       cfg: TransformerConfig, cache: KVCache,
                       first_chunk: bool = False, mesh=None
                       ) -> tuple[torch.Tensor, KVCache]:
    """tokens [B, T] appended at ``cache.pos`` -> (logits [B,T,vocab],
    cache).  The cache tensors are written in place; the returned
    KVCache shares them, with ``pos`` advanced by T.

    ``first_chunk``: the caller guarantees ``cache.pos == 0``, so
    attention runs causally against just the chunk's own K/V — through
    the flash kernel on the card.  Wrong results if asserted on a
    non-empty cache (earlier keys would be ignored).

    ``mesh``: this rank's blocks of the weights and its cache of
    :func:`init_cache` under the same mesh (module docstring); the
    logits are whole on every rank."""
    _refuse_tp(cfg, mesh, params)
    params = _with_layers(params, cfg)
    b, t = tokens.shape
    size = cache.k[0].shape[1]
    pos = int(cache.pos)
    if pos + t > size:
        raise ValueError(
            f"{t} tokens at position {pos} cannot fit a {size}-slot "
            f"cache")
    positions = pos + torch.arange(t, device=tokens.device)
    x = _embed(params, tokens, cfg, mesh)

    def write(dst, new):
        dst[:, pos:pos + t] = new

    for i, layer in enumerate(params["layers"]):
        ks, vs = _layer_scales(cache, i)
        q, k, v = _project_and_write(layer, x, positions, cfg, cache.k[i],
                                     cache.v[i], ks, vs, write)
        if first_chunk and t > 1:
            # the chunk's own K/V, unquantized: only cached entries
            # round-trip through int8
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True,
                                window=cfg.attention_window or None)
        else:
            o = _cached_attention(q, cache.k[i], cache.v[i], pos, t, cfg,
                                  ks, vs)
        x = _attn_mlp_tail(x, o, layer, cfg, mesh=mesh)
    x = rms_norm(x, params["ln_f"])
    logits = _unembed(x, params, mesh)
    return logits, dataclasses.replace(cache, pos=pos + t)


def _layer_scales(cache: KVCache, i: int):
    """Layer ``i``'s (k_scale, v_scale), or (None, None) for a
    model-dtype cache."""
    if cache.k_scale is None:
        return None, None
    return cache.k_scale[i], cache.v_scale[i]


#: the prompt-fill launch site (the JAX package's ``_prefill_jit``)
_prefill = dispatch.counted("prefill")(forward_with_cache)


def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            cache: KVCache, mesh=None) -> tuple[torch.Tensor, KVCache]:
    """Append the prompt chunk to the cache: the flash path on a fresh
    cache, the masked full-cache path on a non-empty one (chunked or
    multi-turn prefill), correct at any position.  ``mesh`` as
    :func:`forward_with_cache` takes it."""
    return _prefill(params, tokens, cfg, cache, cache.pos == 0, mesh=mesh)


@dispatch.counted("decode_step")
def decode_step(params: Params, token: torch.Tensor,
                cfg: TransformerConfig, cache: KVCache, mesh=None
                ) -> tuple[torch.Tensor, KVCache]:
    """token [B, 1] appended at ``cache.pos`` -> (logits [B, vocab],
    cache), the cache written in place.  ``mesh`` as
    :func:`forward_with_cache` takes it."""
    logits, cache = forward_with_cache(params, token, cfg, cache,
                                       mesh=mesh)
    return logits[:, 0], cache


def _layer_lora(lora, i: int):
    """Layer ``i``'s slice of a ``lora`` argument ``(slots [B], layers)``
    (``layers[i] = (aq, bq, ao, bo)``, the pool's buffers): ``(slots,
    aq, bq, ao, bo)``, or None without adapters."""
    if lora is None:
        return None
    return (lora[0].long(),) + tuple(lora[1][i])


def _rows_forward(params: Params, tokens: torch.Tensor,
                  cfg: TransformerConfig, cache: KVCache,
                  pos_rows: torch.Tensor, lora=None, mesh=None
                  ) -> tuple[torch.Tensor, KVCache]:
    """tokens [B, T] appended at PER-ROW positions ``pos_rows`` [B] ->
    (logits [B, T, vocab], cache).  ``cache.pos`` is ignored: writes
    land at each row's own offset and attention masks per row.

    ``lora`` is ``(slots [B], layers)`` with ``layers[i] = (aq, bq, ao,
    bo)``, the pooled adapter buffers (serving_lora/): each row gathers
    its adapter's factors by slot id, so a batch of mixed adapters is
    one pass of fixed shapes.  ``mesh`` as :func:`forward_with_cache`
    takes it; under tp the buffers are this rank's cut
    (``serving_lora.pool.shard_lora_buffers``)."""
    _refuse_tp(cfg, mesh, params)
    params = _with_layers(params, cfg)
    b, t = tokens.shape
    dev = tokens.device
    pos_rows = pos_rows.to(device=dev, dtype=torch.long)
    positions = pos_rows[:, None] + torch.arange(t, device=dev)[None]
    rows = torch.arange(b, device=dev)[:, None].expand(b, t)
    x = _embed(params, tokens, cfg, mesh)

    def write_rows(dst, new):
        dst[rows, positions] = new

    for i, layer in enumerate(params["layers"]):
        ks, vs = _layer_scales(cache, i)
        lr = _layer_lora(lora, i)
        q, _, _ = _project_and_write(layer, x, positions, cfg, cache.k[i],
                                     cache.v[i], ks, vs, write_rows, lr)
        o = _cached_attention(q, cache.k[i], cache.v[i], pos_rows, t, cfg,
                              ks, vs)
        x = _attn_mlp_tail(x, o, layer, cfg, lr, mesh)
    x = rms_norm(x, params["ln_f"])
    logits = _unembed(x, params, mesh)
    return logits, cache


@dispatch.counted("decode_step_rows")
def decode_step_rows(params: Params, token: torch.Tensor,
                     cfg: TransformerConfig, cache: KVCache,
                     pos_rows: torch.Tensor, lora=None, mesh=None
                     ) -> tuple[torch.Tensor, KVCache]:
    """One decode step with PER-ROW positions: token [B, 1], pos_rows
    [B] (each slot's fill depth) -> (logits [B, vocab], cache).  The
    continuous-batching primitive (models/serving.py); ``lora`` and
    ``mesh`` as :func:`_rows_forward` takes them."""
    b, t = token.shape
    if t != 1:
        raise ValueError(f"decode_step_rows is one token per slot, "
                         f"got T={t}")
    logits, cache = _rows_forward(params, token, cfg, cache, pos_rows, lora,
                                  mesh)
    return logits[:, 0], cache


def _filter_logits(logits, temperature, top_k: int = 0,
                   top_p: float = 0.0):
    """The temperature/top-k/top-p transform on raw logits (f32);
    softmax of the result is the distribution sampling draws from.
    ``temperature`` is a scalar or per-row over the leading dims."""
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=logits.device).clamp_min(1e-6)
    if temp.ndim:
        temp = temp[..., None]          # per-row over the vocab dim
    scaled = logits.float() / temp
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled, _NEG_INF)
    if top_p and top_p < 1.0:
        # nucleus: drop tokens outside the smallest prefix of the
        # sorted distribution with cumulative mass >= p (the top
        # token always survives: its cumsum term includes itself)
        srt = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, srt, -torch.inf).amax(dim=-1,
                                                         keepdim=True)
        scaled = torch.where(scaled >= cutoff, scaled, _NEG_INF)
    return scaled


def sample_token(logits, generator, temperature, top_k: int = 0,
                 top_p: float = 0.0):
    """Temperature/top-k/top-p transform + categorical draw from
    ``generator``: ``[..., V]`` logits -> ``[...]`` token ids."""
    probs = torch.softmax(
        _filter_logits(logits, temperature, top_k, top_p), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)[:, 0]
    return draw.reshape(probs.shape[:-1])


def select_next_tokens(logits, generators, temps, top_k: int = 0,
                       top_p: float = 0.0):
    """Per-row greedy/sampled next-token merge: ``[B, V]`` logits,
    per-row ``generators`` (a greedy row's is never drawn from, and may
    be None) and ``temps`` (0 = greedy) -> next tokens [B] (long, on
    the logits' device).  Greedy
    rows take the raw argmax; each sampled row draws from its own
    generator, so a row's tokens never depend on its batch mates.  The
    one definition behind the engine's step and its batched fills."""
    nxt = logits.argmax(dim=-1)
    for i, temp in enumerate(temps):
        if temp > 0:
            nxt[i] = sample_token(logits[i], generators[i], float(temp),
                                  top_k, top_p)
    return nxt


def sample_rows(logits, generators, temps, top_k: int = 0,
                top_p: float = 0.0):
    """The form of :func:`select_next_tokens` that a CUDA graph can
    hold: ``temps`` is a [B] float32 tensor on the logits' device and
    every row has a generator.  Every row draws from its own generator
    through :func:`sample_token` on its own [V] row (a greedy row draws
    at temperature 1 and its draw is discarded), and greedy rows take
    the raw argmax, merged on the device with ``torch.where``: no host
    branch and no host value.  A sampled row runs the same ops with the
    same temperature as in :func:`select_next_tokens` and consumes its
    generator the same way, so it draws the same token."""
    sampled = temps > 0
    draw_t = torch.where(sampled, temps, 1.0)
    draws = torch.stack([
        sample_token(logits[i], gen, draw_t[i], top_k, top_p)
        for i, gen in enumerate(generators)])
    return torch.where(sampled, draws, logits.argmax(dim=-1))


# -- speculative decoding ----------------------------------------------
#
# A draft source proposes ``draft_len`` tokens a row (the draft model's
# k+1-step loop, or the n-gram lookup over the row's prompt), one target
# forward scores the whole window (``decode_window_rows``: _rows_forward
# at T = draft_len + 1), and each row keeps its accepted prefix plus one
# correction / bonus token (``spec_accept_rows``).  Rollback is
# positional: rejected rows stay in the cache, masked by position, and
# the next window rewrites the same offsets.  Every body here is plain
# torch with no host value, so the fused speculative block can capture
# it; each sampled row draws from its own generator, the same number of
# draws a window whatever it accepts, so a row's stream does not depend
# on how its windows are packaged.


@dispatch.counted("decode_window_rows")
def decode_window_rows(params: Params, tokens: torch.Tensor,
                       cfg: TransformerConfig, cache: KVCache,
                       pos_rows: torch.Tensor, lora=None, mesh=None
                       ) -> tuple[torch.Tensor, KVCache]:
    """Multi-token per-row step: tokens [B, T] appended at each row's
    own position -> (logits [B, T, vocab], cache), the target-scoring
    half of speculative continuous batching.  Rejected rows past the
    accepted prefix stay in the cache, position-masked, and the next
    window overwrites them at the same offsets.  ``lora`` and ``mesh``
    as :func:`_rows_forward` takes them: drafts stay base-model, the
    target judges with each row's adapter."""
    return _rows_forward(params, tokens, cfg, cache, pos_rows, lora, mesh)


@dispatch.counted("draft_propose_rows")
def draft_propose_rows(params: Params, last: torch.Tensor,
                       cfg: TransformerConfig, cache: KVCache,
                       pos_rows: torch.Tensor, k: int, mesh=None
                       ) -> tuple[torch.Tensor, KVCache]:
    """``k`` greedy draft proposals a row: ``last`` [B] then each
    proposal fed back, k+1 steps, so the LAST proposal's K/V row lands
    too (a full accept advances past it; a missing row would degrade
    every later draft).  Returns (proposals [B, k], cache); rows
    pos..pos+k written.  ``mesh`` as :func:`_rows_forward` takes it
    (the draft's blocks and cache under the target's mesh): the logits
    are whole on every rank, so every rank proposes the same tokens."""
    tok, pos, out = last, pos_rows, []
    for _ in range(k + 1):
        logits, cache = _rows_forward(params, tok[:, None], cfg, cache, pos,
                                      mesh=mesh)
        tok = logits[:, 0].argmax(dim=-1)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out[:k], dim=1), cache


def _draw_rows(probs: torch.Tensor, generators) -> torch.Tensor:
    """One categorical draw per row of ``probs`` [B, V], each from its
    row's generator: [B] long.  One-sample ``multinomial`` draws V
    exponentials whatever the probabilities, so every call consumes a
    row's generator by the same amount."""
    return torch.stack([torch.multinomial(probs[i], 1, generator=g)[0]
                        for i, g in enumerate(generators)])


def _draft_scan(params: Params, last: torch.Tensor, cfg: TransformerConfig,
                cache: KVCache, pos_rows: torch.Tensor, k: int, generators,
                temps: torch.Tensor, top_k: int, top_p: float, mesh=None
                ) -> tuple[torch.Tensor, torch.Tensor, KVCache]:
    """The sampled draft's k+1-step loop, shared by
    :func:`draft_sample_rows` and the fused speculative block (plain:
    a dispatch label inside a captured block would count its capture,
    not its replays).  Each step filters the draft logits at the row's
    temperature (``temps`` [B] on the device), draws every row from its
    draft-side generator, and keeps the draw for sampled rows and the
    raw argmax for greedy ones (``torch.where``, no host branch).
    ``mesh`` as :func:`draft_propose_rows` takes it: each rank draws
    from its own generators, seeded alike, on the same whole logits.
    Returns (proposals [B, k], q_probs [B, k, V], cache)."""
    tok, pos, props, qs = last, pos_rows, [], []
    for _ in range(k + 1):
        logits, cache = _rows_forward(params, tok[:, None], cfg, cache, pos,
                                      mesh=mesh)
        q = torch.softmax(_filter_logits(logits[:, 0], temps, top_k, top_p),
                          dim=-1)
        tok = torch.where(temps > 0, _draw_rows(q, generators),
                          logits[:, 0].argmax(dim=-1))
        props.append(tok)
        qs.append(q)
        pos = pos + 1
    return torch.stack(props[:k], dim=1), torch.stack(qs[:k], dim=1), cache


@dispatch.counted("draft_sample_rows")
def draft_sample_rows(params: Params, last: torch.Tensor,
                      cfg: TransformerConfig, cache: KVCache,
                      pos_rows: torch.Tensor, k: int, generators,
                      temps: torch.Tensor, top_k: int = 0,
                      top_p: float = 0.0, mesh=None
                      ) -> tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Sampled draft proposals for rejection-sampling speculation:
    ``k`` tokens a row, each drawn from the draft's filtered
    distribution at the row's temperature (greedy rows take the
    argmax), plus those distributions ``q_probs`` [B, k, V], which
    :func:`spec_accept_rows` divides by.  Same k+1-step contract as
    :func:`draft_propose_rows`, ``mesh`` as it takes it.  Returns
    (proposals, q_probs, cache)."""
    return _draft_scan(params, last, cfg, cache, pos_rows, k, generators,
                       temps, top_k, top_p, mesh)


def ngram_propose_rows(ctx: torch.Tensor, ctx_len: torch.Tensor,
                       last: torch.Tensor, k: int) -> torch.Tensor:
    """Model-free prompt-lookup draft: per row, the ``k`` tokens that
    followed the LAST occurrence of ``last`` in the row's context.
    ``ctx`` [B, C] (zero-padded prompts), ``ctx_len`` [B] valid lengths,
    ``last`` [B] -> proposals [B, k] (long).  Only matches with a full
    k-token continuation inside the context qualify (``i + k <
    ctx_len``), so zero padding never matches; a row with no match
    proposes ``last`` repeated.  A pure gather."""
    c = ctx.shape[1]
    idx = torch.arange(c, device=ctx.device)[None]
    m = (ctx == last[:, None]) & (idx + k < ctx_len[:, None])
    at = torch.where(m, idx, -1).amax(dim=1)
    cols = (at[:, None] + 1
            + torch.arange(k, device=ctx.device)[None]).clamp(0, c - 1)
    prop = ctx.gather(1, cols).long()
    return torch.where(m.any(dim=1)[:, None], prop, last[:, None].long())


def _one_hot(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """[...] ids -> [..., vocab] float32 point masses (a scatter, which a
    captured graph can hold)."""
    out = torch.zeros(*tokens.shape, vocab, dtype=torch.float32,
                      device=tokens.device)
    return out.scatter_(-1, tokens[..., None].long(), 1.0)


@dispatch.counted("draft_ngram_rows")
def draft_ngram_rows(ctx: torch.Tensor, ctx_len: torch.Tensor,
                     last: torch.Tensor, k: int, vocab: int,
                     want_q: bool = False):
    """The n-gram draft's launch site on the step path: (proposals
    [B, k], their one-hot ``q_probs`` [B, k, V] when ``want_q`` else
    None), under its own ``draft_*`` label."""
    prop = ngram_propose_rows(ctx, ctx_len, last, k)
    return prop, (_one_hot(prop, vocab) if want_q else None)


def _target_probs(logits: torch.Tensor, temps: torch.Tensor, top_k: int,
                  top_p: float) -> torch.Tensor:
    """The target's distributions over a window that the acceptance
    test divides by the draft's: ``logits`` [B, K+1, V] filtered at
    each row's temperature (``temps`` [B]), then softmaxed."""
    return torch.softmax(_filter_logits(logits, temps[:, None], top_k, top_p),
                         dim=-1)


def _spec_accept_body(logits: torch.Tensor, proposals: torch.Tensor,
                      q_probs: torch.Tensor, generators,
                      temps: torch.Tensor, top_k: int, top_p: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The verify-accept body behind :func:`spec_accept_rows` and the
    fused speculative block (plain, as :func:`_draft_scan`).  Every row
    draws ``k`` uniforms and one residual token from its own generator,
    whatever it accepts; greedy rows (temperature 0) discard both."""
    b, k1, v = logits.shape
    k = k1 - 1
    dev = logits.device
    props = proposals.long()
    greedy = logits.argmax(dim=-1)                               # [B, K+1]
    p = _target_probs(logits, temps, top_k, top_p)
    u = torch.stack([torch.rand(k, generator=g, device=dev)
                     for g in generators])
    p_x = p[:, :k].gather(-1, props[..., None])[..., 0]
    q_x = q_probs.gather(-1, props[..., None])[..., 0]
    sampled = temps > 0
    accept = torch.where(sampled[:, None],
                         u < (p_x / q_x.clamp_min(1e-30)).clamp(max=1.0),
                         props == greedy[:, :k])
    a = accept.long().cumprod(dim=1).sum(dim=1)                  # [B]
    # the correction's distribution at the first reject, or the bonus
    # position K on a full accept, where nothing is subtracted
    p_a = p.gather(1, a[:, None, None].expand(b, 1, v))[:, 0]
    q_a = q_probs.gather(1, a.clamp(max=k - 1)[:, None, None]
                         .expand(b, 1, v))[:, 0]
    residual = torch.where((a < k)[:, None], (p_a - q_a).clamp_min(0.0), p_a)
    mass = residual.sum(dim=-1, keepdim=True)
    # zero mass means p <= q everywhere, which forces acceptance: only
    # round-off reaches it, and then p_a itself is the right draw
    safe = torch.where(mass > 0, residual / mass.clamp_min(1e-30), p_a)
    corr = torch.where(sampled, _draw_rows(safe, generators),
                       greedy.gather(1, a[:, None])[:, 0])
    padded = torch.cat([props, props.new_zeros(b, 1)], dim=1)
    emit = torch.where(torch.arange(k + 1, device=dev)[None] == a[:, None],
                       corr[:, None], padded)
    return emit, a


@dispatch.counted("spec_accept_rows")
def spec_accept_rows(logits: torch.Tensor, proposals: torch.Tensor,
                     q_probs: torch.Tensor, generators, temps: torch.Tensor,
                     top_k: int = 0, top_p: float = 0.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row speculative acceptance, greedy and sampled rows in one
    body: target ``logits`` [B, K+1, V] over the window, ``proposals``
    [B, K] with their draft distributions ``q_probs`` [B, K, V], one
    generator a row and ``temps`` [B] on the device -> (emit [B, K+1],
    accepts [B]).

    Greedy rows: a proposal is accepted while it equals the target's
    raw argmax, and the correction / bonus is the argmax at the first
    mismatch, so speculative greedy equals plain greedy.  Sampled rows:
    rejection sampling, accepting proposal i with probability
    ``min(1, p_i(x_i) / q_i(x_i))`` under the samplers' filter, on the
    first reject a draw from ``norm(max(p_i - q_i, 0))``, on a full
    accept the bonus from ``p_K``, so each emitted token is distributed
    as plain sampling of the target (Leviathan et al., Chen et al.).
    ``emit[b, :accepts[b] + 1]`` are the tokens to append."""
    return _spec_accept_body(logits, proposals, q_probs, generators, temps,
                             top_k, top_p)


# -- the fused generation block ---------------------------------------
#
# Up to k per-row decode steps with sampling, KV writes, per-row EOS and
# budget stops and a frozen-row mask all on the device.  One step body
# (_block_step) serves both forms: decode_fused_rows loops it with the
# JAX package's early exit (the CPU path), FusedBlockGraph captures it
# k times into one CUDA graph (the card's form of the JAX package's
# one-dispatch lax.while_loop).  The speculative block
# (decode_spec_fused_rows) is the same machinery with another step
# body, _spec_block_step: one whole speculative window a step.


@dataclasses.dataclass
class _BlockState:
    """The block's inputs and per-row state, one tensor each, updated in
    place by the step bodies (in a graph: its fixed-address buffers).
    ``last``, ``pos``, ``budget`` and ``eos`` are rows of one [4, B]
    long tensor, so the host uploads them in one copy.  A speculative
    block also counts each row's accepted drafts and windows run."""

    ints: torch.Tensor       # [4, B] long: last, pos, budget, eos
    temps: torch.Tensor      # [B] f32 (0 = greedy)
    done: torch.Tensor       # [B] bool
    emitted: torch.Tensor    # [B] int32
    packed: torch.Tensor     # [B, width + counts] int32: tokens, counts
    rows_done: torch.Tensor  # [] long
    accepted: torch.Tensor | None = None   # [B] int32, speculative only
    windows: torch.Tensor | None = None    # [B] int32, speculative only

    @classmethod
    def empty(cls, b: int, width: int, device,
              spec: bool = False) -> "_BlockState":
        """State for blocks of ``width`` token columns a row (k steps,
        or k windows of draft_len + 1 when ``spec``)."""
        def count():
            return torch.zeros(b, dtype=torch.int32, device=device)

        return cls(
            ints=torch.zeros((4, b), dtype=torch.long, device=device),
            temps=torch.zeros(b, dtype=torch.float32, device=device),
            done=torch.zeros(b, dtype=torch.bool, device=device),
            emitted=count(),
            packed=torch.zeros((b, width + (3 if spec else 1)),
                               dtype=torch.int32, device=device),
            rows_done=torch.zeros((), dtype=torch.long, device=device),
            accepted=count() if spec else None,
            windows=count() if spec else None)

    def counts(self) -> list[torch.Tensor]:
        """The per-row counts packed after the tokens, in order."""
        return [c for c in (self.emitted, self.accepted, self.windows)
                if c is not None]

    def load(self, last, pos, budget, eos, temps) -> None:
        """Upload one block's [B] inputs (the step-by-step form)."""
        for row, vals in enumerate((last, pos, budget, eos)):
            self.ints[row] = torch.as_tensor(vals, device=self.ints.device)
        self.temps.copy_(torch.as_tensor(temps, dtype=torch.float32))

    def begin(self) -> None:
        """Start a block from the uploaded inputs: a row of budget 0 is
        frozen from step 0."""
        torch.le(self.ints[2], 0, out=self.done)
        for c in self.counts():
            c.zero_()
        self.packed.zero_()

    def finish(self) -> None:
        counts = self.counts()
        self.packed[:, -len(counts):] = torch.stack(counts, dim=1)
        self.rows_done.copy_(self.done.sum())


def _block_step(params: Params, cfg: TransformerConfig, cache: KVCache,
                s: _BlockState, j: int, generators, top_k: int,
                top_p: float, lora=None, mesh=None) -> None:
    """Step ``j`` of the block, in place on ``s`` and the cache.  A
    frozen row keeps its position, ``last`` and count; its K/V write
    lands at its frozen position, the slot just past what it emitted
    (in bounds: its budget stopped it at ``max_seq - 1``), which no
    live query reads.  Its generator still draws; the draw is
    discarded, and a frozen row never runs again before its slot is
    refilled and its generator reseeded.  ``lora`` as
    :func:`_rows_forward` takes it; a frozen or free row reads the slot
    id it was given, the null adapter once its slot was released.
    ``mesh`` as :func:`_rows_forward` takes it."""
    last, pos, budget, eos = s.ints
    logits, _ = _rows_forward(params, last[:, None], cfg, cache, pos, lora,
                              mesh)
    nxt = sample_rows(logits[:, 0], generators, s.temps, top_k, top_p)
    alive = ~s.done
    s.packed[:, j] = torch.where(alive, nxt, 0)
    s.emitted += alive
    pos += alive
    last.copy_(torch.where(alive, nxt, last))
    s.done |= alive & (((eos >= 0) & (nxt == eos)) | (s.emitted >= budget))


@dispatch.counted("decode_fused_rows")
def decode_fused_rows(params: Params, last: torch.Tensor,
                      cfg: TransformerConfig, cache: KVCache,
                      pos_rows: torch.Tensor, k: int, generators,
                      temps: torch.Tensor, budget: torch.Tensor,
                      eos: torch.Tensor, top_k: int = 0, top_p: float = 0.0,
                      lora=None, mesh=None
                      ) -> tuple[torch.Tensor, torch.Tensor, KVCache]:
    """The generation block, step by step: up to ``k`` per-row decode
    steps of :func:`_block_step`, leaving as soon as every row is done
    (the JAX package's ``lax.while_loop``; the host reads ``done``
    between steps, which on the card costs a sync a step, so the
    engine replays a :class:`FusedBlockGraph` there instead).

    ``last``, ``pos_rows``, ``budget`` (tokens each row may still emit;
    0 = inactive from step 0) and ``eos`` (-1 = none) are [B];
    ``temps`` [B] (0 = greedy) and ``generators`` one per row, as
    :func:`sample_rows` takes them.  Returns ``(packed [B, k+1] int32,
    rows_finished [], cache)``: ``packed[:, :k]`` the tokens (0 past a
    row's count), ``packed[:, k]`` each row's emitted count; the cache
    is written in place.  ``lora`` and ``mesh`` as :func:`_rows_forward`
    takes them.  Under a mesh this step-by-step form is also the card's:
    gloo's host-staged collectives cannot be captured in a CUDA graph,
    and every rank reads the same ``done`` (whole logits, generators
    seeded alike), so every rank leaves after the same step."""
    s = _BlockState.empty(last.shape[0], k, cache.k[0].device)
    s.load(last, pos_rows, budget, eos, temps)
    s.begin()
    for j in range(k):
        if bool(s.done.all()):
            break
        _block_step(params, cfg, cache, s, j, generators, top_k, top_p,
                    lora, mesh)
    s.finish()
    return s.packed, s.rows_done, cache


@dataclasses.dataclass
class SpecDraft:
    """What a speculative window drafts from: ``length`` proposals a row
    from the draft model (``params``, ``cfg``, its [B, S] ``cache`` and
    one draft-side generator a row), or, with ``params`` None, from the
    n-gram lookup over ``ctx`` [B, C] with valid lengths ``ctx_len``
    [B].  Under ``mesh`` the draft model's ``params`` and ``cache`` are
    this rank's blocks (as :func:`_draft_scan` takes them)."""

    length: int
    params: Params | None = None
    cfg: TransformerConfig | None = None
    cache: KVCache | None = None
    generators: list | None = None
    ctx: torch.Tensor | None = None
    ctx_len: torch.Tensor | None = None
    mesh: object = None

    def propose(self, last, pos, temps, top_k: int, top_p: float,
                vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(proposals [B, length], q_probs [B, length, vocab]); the
        draft model writes its cache rows pos..pos+length in place."""
        if self.params is None:
            prop = ngram_propose_rows(self.ctx, self.ctx_len, last,
                                      self.length)
            return prop, _one_hot(prop, vocab)
        prop, q, _ = _draft_scan(self.params, last, self.cfg, self.cache,
                                 pos, self.length, self.generators, temps,
                                 top_k, top_p, self.mesh)
        return prop, q


def _spec_block_step(params: Params, cfg: TransformerConfig,
                     cache: KVCache, s: _BlockState, generators,
                     top_k: int, top_p: float, draft: SpecDraft,
                     lora=None, mesh=None) -> None:
    """One speculative window of the block, in place on ``s`` and the
    caches: draft, one target window forward, verify-accept, then each
    live row appends ``min(accepts + 1, its first EOS, its remaining
    budget)`` tokens at its next free columns of ``s.packed``.

    A frozen row appends nothing and keeps its position; its window
    writes land at [pos, pos + draft_len] past its finish line (in
    bounds: the engine's capacity margin is draft_len + 1 for fused
    speculation), which no live query reads, and its draws are
    discarded, as in :func:`_block_step`.  The draft stays base-model;
    ``lora`` (as :func:`_rows_forward` takes it) reaches the target
    window only, so each row is judged by its adapter's model; ``mesh``
    reaches the target window (the draft model reads ``draft.mesh``)."""
    last, pos, budget, eos = s.ints
    kd = draft.length
    cap = s.packed.shape[1] - 3
    proposals, q_probs = draft.propose(last, pos, s.temps, top_k, top_p,
                                       cfg.vocab)
    window = torch.cat([last[:, None], proposals], dim=1)
    logits, _ = _rows_forward(params, window, cfg, cache, pos, lora, mesh)
    emit, a = _spec_accept_body(logits, proposals, q_probs, generators,
                                s.temps, top_k, top_p)
    alive = ~s.done
    steps = torch.arange(kd + 1, device=last.device)[None]
    n0 = a + 1
    hit = (eos[:, None] >= 0) & (emit == eos[:, None]) & (steps < n0[:, None])
    has = hit.any(dim=1)
    first = hit.long().argmax(dim=1)
    n = torch.minimum(torch.where(has, first + 1, n0), budget - s.emitted)
    n = torch.where(alive, n, 0)
    # tokens past a row's count go to column ``cap``, the emitted
    # count's, which finish() overwrites
    cols = torch.where(steps < n[:, None], s.emitted[:, None] + steps, cap)
    s.packed.scatter_(1, cols, emit.to(torch.int32))
    last.copy_(torch.where(
        alive, emit.gather(1, (n - 1).clamp(0, kd)[:, None])[:, 0], last))
    pos += n
    s.emitted += n
    s.accepted += torch.minimum(n, a)
    s.windows += alive
    s.done |= alive & ((has & (first < n)) | (s.emitted >= budget))


@dispatch.counted("decode_spec_fused_rows")
def decode_spec_fused_rows(params: Params, last: torch.Tensor,
                           cfg: TransformerConfig, cache: KVCache,
                           pos_rows: torch.Tensor, k: int, generators,
                           temps: torch.Tensor, budget: torch.Tensor,
                           eos: torch.Tensor, ctx: torch.Tensor | None,
                           ctx_len: torch.Tensor | None,
                           draft_params: Params | None,
                           draft_cfg: TransformerConfig | None,
                           draft_cache: KVCache | None,
                           draft_generators, draft_len: int,
                           top_k: int = 0, top_p: float = 0.0, lora=None,
                           mesh=None
                           ) -> tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Speculation inside the fused block, step by step: up to ``k``
    windows of :func:`_spec_block_step` a row, leaving as soon as every
    row is done.  Each window drafts ``draft_len`` proposals (the draft
    model when ``draft_params`` is given, with ``draft_cache`` and one
    draft generator a row; else the n-gram lookup over ``ctx`` /
    ``ctx_len``), scores them in one target forward and accepts per row
    on the device.  Inputs as :func:`decode_fused_rows` (``mesh`` too: the
    card's form under a mesh); ``lora`` reaches the target window
    only.

    Returns ``(packed [B, k*(draft_len+1) + 3], rows_finished, cache)``:
    the token block, then each row's emitted count, accepted drafts and
    windows run.  Both caches are written in place; on the card the
    engine replays a :class:`FusedBlockGraph` built with a
    :class:`SpecDraft` instead."""
    draft = SpecDraft(draft_len, draft_params, draft_cfg, draft_cache,
                      draft_generators, ctx, ctx_len, mesh)
    s = _BlockState.empty(last.shape[0], k * (draft_len + 1),
                          cache.k[0].device, spec=True)
    s.load(last, pos_rows, budget, eos, temps)
    s.begin()
    for _ in range(k):
        if bool(s.done.all()):
            break
        _spec_block_step(params, cfg, cache, s, generators, top_k, top_p,
                         draft, lora, mesh)
    s.finish()
    return s.packed, s.rows_done, cache


def block_length(k: int, need: int) -> int:
    """The captured length a block of at most ``k`` steps replays when
    its active rows may emit at most ``need`` tokens: the smallest of
    1, 2, 4, ... (below ``k``) and ``k`` that is at least
    ``min(k, need)``.  At most about log2(k) + 1 graphs per engine;
    steps past every row's stop run frozen (device time only, the
    same tokens)."""
    want = min(k, max(need, 1))
    n = 1
    while n < want:
        n *= 2
    return min(n, k)


def _tensor_ptrs(tree) -> list[int]:
    """Every tensor's data pointer in a parameter tree (dicts, lists,
    ``QTensor``s), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree.data_ptr()]
    if isinstance(tree, QTensor):
        return [tree.q.data_ptr(), tree.scale.data_ptr()]
    if isinstance(tree, dict):
        return [p for key in sorted(tree) for p in _tensor_ptrs(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [p for item in tree for p in _tensor_ptrs(item)]
    return []


def _k7_counts() -> tuple[dict, int]:
    """K7's launch counters (models/quant.py), the only kernel the
    block's forwards launch: the contiguous caches are read by plain
    ops, and serving's MoE layers take the dense dispatch."""
    return dict(quant.launches), quant.tc_launches


class FusedBlockGraph:
    """The fused block on the card: one CUDA graph per block length
    (:func:`block_length`), captured lazily, each that many steps of
    :func:`_block_step` between ``begin`` and ``finish``; a block is one
    replay, one upload of the inputs and one readback of the packed
    array and the rows-finished count.  With ``draft`` (a
    :class:`SpecDraft`) each step is one speculative window
    (:func:`_spec_block_step`) and a block is one
    ``decode_spec_fused_rows``.

    - **Fixed-address buffers**: a :class:`_BlockState` (the inputs
      ``last``/``pos``/``budget``/``eos``/``temps``, the packed output,
      the rows-finished count), pinned host twins for the uploads and
      the two readbacks, and one memory pool shared by this runner's
      graphs (nothing a graph allocates outlives its replay, and the
      graphs run one after another on one stream).  The n-gram source's
      context and lengths are fixed buffers too, uploaded with each
      block's inputs.
    - **Adapters**: with ``lora_buffers`` (an ``AdapterPool``'s
      ``buffers``, serving_lora/) every step adds each row's LoRA
      deltas, gathered by the row's slot id from a fixed [B] long
      buffer that ``launch`` uploads with the block's inputs.  The
      pool's loads write its buffers in place, and the slot ids are
      data, so binds, releases, cold loads and evictions between
      blocks change contents only and capture nothing.
    - **Generators**: ``generators`` (one persistent generator per
      slot, reseeded by the engine at each fill), and a draft model's
      draft-side generators, are registered with every graph; a replay
      reads each one's seed and offset as the host holds them and
      advances the offset by what the captured steps draw, as the same
      steps would eagerly.
    - **Warm-up**: before each capture, one step runs eagerly with
      every row frozen, so lazy set-up happens outside the capture.
      Its K/V writes land at each row's current position (a window's:
      at pos..pos+draft_len, in the target and the draft cache), which
      the block's first step rewrites (an active row) or no live query
      reads (a free slot); its draws are undone by restoring each
      generator's seed and offset by value (``get_state``/
      ``set_state``: ``graphsafe_set_state`` would swap the state
      object the graphs hold).
    - **Bindings**: the data pointers of the parameters and the cache a
      graph captured, of the draft model's, and of the adapter buffers
      and slot ids, are checked before each replay; a rebind raises and
      nothing is recaptured behind the caller's back.
    - **Launch counts**: K7's counters move while a graph is captured,
      not while it replays (nothing runs at capture), so each capture's
      change is taken back and added at every replay of that graph;
      ``passes`` counts the target forward passes run on the card
      (warm-ups and replayed steps or windows) and ``draft_passes`` the
      draft model's (draft_len + 1 a window), the passes those launches
      serve.

    No fallback: a failed capture or replay raises."""

    def __init__(self, params: Params, cfg: TransformerConfig,
                 cache: KVCache, generators, k: int, top_k: int = 0,
                 top_p: float = 0.0, draft: SpecDraft | None = None,
                 lora_buffers=None):
        dev = cache.k[0].device
        if dev.type != "cuda":
            raise ValueError(f"FusedBlockGraph runs on the card, the cache "
                             f"is on {dev}; decode_fused_rows is the "
                             f"step-by-step form")
        b = len(generators)
        self.k = k
        self._draft = draft
        self._gens = list(generators)
        width = k
        self._host_ctx = None
        if draft is not None:
            width = k * (draft.length + 1)
            self._gens += list(draft.generators or [])
            if draft.params is None:
                c = cache.k[0].shape[1]
                draft.ctx = torch.zeros((b, c), dtype=torch.int32,
                                        device=dev)
                draft.ctx_len = torch.zeros(b, dtype=torch.int32, device=dev)
                self._host_ctx = torch.zeros((b, c),
                                             dtype=torch.int32).pin_memory()
                self._host_ctx_len = torch.zeros(
                    b, dtype=torch.int32).pin_memory()
        self._lora = None
        if lora_buffers is not None:
            self._lora = (torch.zeros(b, dtype=torch.long, device=dev),
                          lora_buffers)
            self._host_slots = torch.zeros(b, dtype=torch.long).pin_memory()
        self._body = (params, cfg, cache, list(generators), top_k, top_p)
        self._bound = self._pointers(params, cache, lora_buffers)
        self._s = _BlockState.empty(b, width, dev, spec=draft is not None)
        self._host_ints = torch.zeros((4, b), dtype=torch.long).pin_memory()
        self._host_temps = torch.zeros(b, dtype=torch.float32).pin_memory()
        self._host_packed = torch.zeros(tuple(self._s.packed.shape),
                                        dtype=torch.int32).pin_memory()
        self._host_done = torch.zeros((), dtype=torch.long).pin_memory()
        self._ready = torch.cuda.Event()
        self._pool = torch.cuda.graph_pool_handle()
        self._graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self._k7_delta: dict[int, tuple[dict, int]] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.passes = 0
        self.draft_passes = 0

    def _pointers(self, params: Params, cache: KVCache, lora_buffers) -> list:
        ptrs = [_tensor_ptrs(params), _tensor_ptrs(cache.tensors())]
        d = self._draft
        if d is not None and d.params is not None:
            ptrs += [_tensor_ptrs(d.params), _tensor_ptrs(d.cache.tensors())]
        if self._lora is not None:
            ptrs += [_tensor_ptrs(lora_buffers), [self._lora[0].data_ptr()]]
        return ptrs

    def _step(self, j: int) -> None:
        params, cfg, cache, gens, top_k, top_p = self._body
        if self._draft is None:
            _block_step(params, cfg, cache, self._s, j, gens, top_k, top_p,
                        self._lora)
        else:
            _spec_block_step(params, cfg, cache, self._s, gens, top_k,
                             top_p, self._draft, self._lora)

    def _count_passes(self, steps: int) -> None:
        self.passes += steps
        if self._draft is not None and self._draft.params is not None:
            self.draft_passes += steps * (self._draft.length + 1)

    def _capture(self, n: int) -> None:
        t0 = time.perf_counter()
        saved = [g.get_state() for g in self._gens]
        self._s.begin()
        self._s.done.fill_(True)
        self._step(0)
        for g, state in zip(self._gens, saved):
            g.set_state(state)
        self._count_passes(1)
        before = _k7_counts()
        graph = torch.cuda.CUDAGraph()
        for g in self._gens:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph, pool=self._pool):
            self._s.begin()
            for j in range(n):
                self._step(j)
            self._s.finish()
        after = _k7_counts()
        quant.launches.update(before[0])
        quant.tc_launches = before[1]
        self._k7_delta[n] = ({name: after[0][name] - before[0][name]
                              for name in after[0]}, after[1] - before[1])
        self._graphs[n] = graph
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def launch(self, params: Params, cache: KVCache, last, pos, temps,
               budget, eos, ctx=None, ctx_len=None, lora=None) -> int:
        """Upload one block's inputs (host arrays of [B]; the n-gram
        source's ``ctx`` [B, C] and ``ctx_len`` [B] too; with adapters,
        ``lora`` = (each row's pool slot id [B], the pool's buffers)),
        replay the graph of its length, and queue the readback; the
        caches are written in place.  Returns the block's length (steps,
        or windows) at once: :meth:`collect` waits.

        A speculative block replays the fewest windows that could finish
        every row at full acceptance (a window emits at most draft_len +
        1 tokens a row), rounded up by :func:`block_length`; a row still
        live after them rides the next block."""
        if (lora is None) != (self._lora is None):
            raise ValueError("the block's graphs were built "
                             + ("without" if lora is not None else "with")
                             + " adapter buffers")
        if self._pointers(params, cache, None if lora is None
                          else lora[1]) != self._bound:
            raise RuntimeError("the parameters, a cache or the adapter "
                               "buffers moved since the block's graphs "
                               "were captured")
        need = int(max(budget))
        if self._draft is None:
            dispatch.COUNTER.record("decode_fused_rows")
        else:
            dispatch.COUNTER.record("decode_spec_fused_rows")
            need = -(-need // (self._draft.length + 1))
        n = block_length(self.k, need)
        for row, vals in enumerate((last, pos, budget, eos)):
            self._host_ints[row] = torch.as_tensor(vals)
        self._host_temps.copy_(torch.as_tensor(temps))
        self._s.ints.copy_(self._host_ints, non_blocking=True)
        self._s.temps.copy_(self._host_temps, non_blocking=True)
        if self._host_ctx is not None:
            self._host_ctx.copy_(torch.as_tensor(ctx))
            self._host_ctx_len.copy_(torch.as_tensor(ctx_len))
            self._draft.ctx.copy_(self._host_ctx, non_blocking=True)
            self._draft.ctx_len.copy_(self._host_ctx_len, non_blocking=True)
        if self._lora is not None:
            self._host_slots.copy_(torch.as_tensor(lora[0]))
            self._lora[0].copy_(self._host_slots, non_blocking=True)
        if n not in self._graphs:
            self._capture(n)
        self._graphs[n].replay()
        names, tc = self._k7_delta[n]
        for name, count in names.items():
            quant.launches[name] += count
        quant.tc_launches += tc
        self.replays += 1
        self._count_passes(n)
        self._host_packed.copy_(self._s.packed, non_blocking=True)
        self._host_done.copy_(self._s.rows_done, non_blocking=True)
        self._ready.record()
        return n

    def collect(self) -> tuple[np.ndarray, int]:
        """Wait for the launched block: (packed [B, width + counts],
        rows finished)."""
        self._ready.synchronize()
        return self._host_packed.numpy().copy(), int(self._host_done)


def scatter_cache(cache: KVCache, one: KVCache, put) -> KVCache:
    """Apply ``put(dst, src)`` (an in-place write) to every per-layer
    tensor pair, k/v and, in an int8 cache, their scales — the single
    definition of the cache layout for the adopt-style scatters
    (serving's slot adoption, ``prefill_adopt_rows``,
    ``suffix_fill_adopt``)."""
    for dst, src in zip(cache.tensors(), one.tensors()):
        put(dst, src)
    return cache


def adopt_one_slot(cache: KVCache, one: KVCache, slot: int) -> KVCache:
    """Copy a [1, S'] cache (S' <= S) into the first S' rows of row
    ``slot``, in place."""
    return scatter_cache(
        cache, one, lambda d, s: d[slot, :s.shape[1]].copy_(s[0]))


@dispatch.counted("prefill_adopt_rows")
def prefill_adopt_rows(params: Params, prompts: torch.Tensor,
                       cfg: TransformerConfig, cache: KVCache,
                       slot_ids, generators, temps, top_k: int = 0,
                       top_p: float = 0.0, mesh=None
                       ) -> tuple[torch.Tensor, KVCache]:
    """Fresh fill of ``n = len(slot_ids)`` same-length requests in one
    call: flash prefill ``prompts`` [m, L] (m >= n) on a transient
    cache, copy the first n rows' K/V into the engine cache at
    ``slot_ids`` (distinct slots), and draw each request's first token
    (argmax for temp 0, else from its generator).  Returns (first
    tokens [n], cache).

    Rows past n are padding, computed and dropped: the engine pads each
    group to its slot count, as the JAX engine does, so that a group's
    shapes, and with them the matrix products' algorithms and rounding,
    do not depend on how many requests share its length.  A request's
    first token and K/V are then the same whatever fills beside it,
    which keeps two schedules of one traffic (a fused and a step
    engine) token-equal on the card.

    Only the prompt's L rows are written into each slot; rows past L
    keep whatever an earlier occupant left there, which no query ever
    reads (position mask) and the decode steps overwrite.

    ``mesh`` as :func:`forward_with_cache` takes it: the transient cache
    and the engine cache hold this rank's ``H_kv/tp`` heads, and the
    first tokens come from the whole logits."""
    n, length = len(slot_ids), prompts.shape[1]
    one = init_cache(cfg, prompts.shape[0], length, device=prompts.device,
                     mesh=mesh)
    logits, one = forward_with_cache(params, prompts, cfg, one,
                                     first_chunk=True, mesh=mesh)
    idx = torch.as_tensor(slot_ids, dtype=torch.long,
                          device=prompts.device)

    def put(dst, src):
        dst[idx, :length] = src[:n]

    cache = scatter_cache(cache, one, put)
    first = select_next_tokens(logits[:n, -1], generators, temps, top_k,
                               top_p)
    return first, cache


@dispatch.counted("suffix_fill_adopt")
def suffix_fill_adopt(params: Params, entry: KVCache,
                      suffix: torch.Tensor, cfg: TransformerConfig,
                      cache: KVCache, slot: int, generator, temp: float,
                      top_k: int = 0, top_p: float = 0.0, mesh=None
                      ) -> tuple[torch.Tensor, KVCache, KVCache]:
    """Prefix-HIT fill: append ``suffix`` [Ls] to a prefix-cache
    ``entry`` ([1, S], ``pos`` = reused rows), copy the result into
    row ``slot`` of the engine cache, and draw the first token.  The
    entry is cloned first — later hits reuse it, and the suffix writes
    would otherwise land in it.  Returns (first token [], cache,
    suffix-filled [1, S] cache for memoization).  ``mesh`` as
    :func:`prefill_adopt_rows` takes it (the entry holds this rank's
    heads)."""
    one = copy_cache(entry, entry.pos)
    logits, one = forward_with_cache(params, suffix[None, :], cfg, one,
                                     mesh=mesh)
    cache = adopt_one_slot(cache, one, slot)
    first = select_next_tokens(logits[:, -1], [generator], [temp],
                               top_k, top_p)
    return first[0], cache, one


# -- paged KV cache (serving_kv/) ------------------------------------
#
# The block-pool twin of the contiguous cache: K/V lives in
# [n_blocks, block_size, H_kv, D] pools and each request reads its
# scattered blocks through a per-request block table; ownership and
# refcounts live host-side in serving_kv/manager.py.


def init_paged_pool(cfg: TransformerConfig, n_blocks: int,
                    block_size: int, device="cuda", mesh=None) -> KVCache:
    """Zero block pool: per-layer [n_blocks, block_size, H_kv, D]
    (block 0 is the null block dead table rows point at); under a
    ``mesh`` whose tp axis is > 1, this rank's ``H_kv/tp`` KV heads.
    The int8 cache is refused, as in the JAX package."""
    if cfg.kv_cache_dtype == "int8":
        raise ValueError("paged KV does not support the int8 cache")
    _refuse_tp(cfg, mesh)
    shape = (n_blocks, block_size, _local_kv_heads(cfg, mesh), cfg.d_head)
    return KVCache(
        k=[torch.zeros(shape, dtype=cfg.dtype, device=device)
           for _ in range(cfg.n_layers)],
        v=[torch.zeros(shape, dtype=cfg.dtype, device=device)
           for _ in range(cfg.n_layers)],
        pos=0)


def _paged_dense(pool_arr, tables):
    """[n_blocks, bs, H_kv, D] pool + [B, n] tables -> the gathered
    dense [B, n*bs, H_kv, D] view (junk in masked tail rows)."""
    b, n = tables.shape
    g = pool_arr[tables.long()]
    return g.reshape(b, n * pool_arr.shape[1], *pool_arr.shape[2:])


def _paged_rows_forward(params, tokens, cfg, pool, tables, pos_rows,
                        use_kernel, lora=None, mesh=None):
    """tokens [B, T] appended at per-row positions into the block pool
    -> (logits [B, T, vocab], pool).  Each token's write lands at
    (tables[b, (pos+t)//bs], (pos+t) % bs).  Dead rows (table rows of
    null blocks) all write into block 0: those writes share indices,
    so which one lands is unspecified on the card, and it does not
    matter because no live row ever reads block 0.  ``use_kernel``
    reads through the paged kernel (single-query); otherwise the
    blocks are gathered into the contiguous cache's shape and read by
    ``_cached_attention``.  ``lora`` and ``mesh`` as
    :func:`_rows_forward` takes them (the pool of
    :func:`init_paged_pool` under the same mesh)."""
    _refuse_tp(cfg, mesh, params)
    params = _with_layers(params, cfg)
    b, t = tokens.shape
    if use_kernel and t > 1:
        raise ValueError("the paged-attention kernel is single-query; "
                         "T > 1 windows use the dense-gather read")
    dev = tokens.device
    pos_rows = pos_rows.to(device=dev, dtype=torch.long)
    positions = pos_rows[:, None] + torch.arange(t, device=dev)[None]
    x = _embed(params, tokens, cfg, mesh)
    bs = pool.k[0].shape[1]
    tl = tables.long()
    phys = [tl.gather(1, ((pos_rows + i) // bs)[:, None])[:, 0]
            for i in range(t)]
    off = [(pos_rows + i) % bs for i in range(t)]

    def write_pool(dst, new):
        for i in range(t):
            dst[phys[i], off[i]] = new[:, i]

    lengths = (pos_rows + 1).to(torch.int32) if use_kernel else None
    for i, (layer, k_pool, v_pool) in enumerate(zip(params["layers"],
                                                    pool.k, pool.v)):
        lr = _layer_lora(lora, i)
        q, _, _ = _project_and_write(layer, x, positions, cfg, k_pool,
                                     v_pool, None, None, write_pool, lr)
        if use_kernel:
            o = paged_attention(q[:, 0].contiguous(), k_pool, v_pool,
                                tables, lengths)[:, None]
        else:
            o = _cached_attention(q, _paged_dense(k_pool, tables),
                                  _paged_dense(v_pool, tables),
                                  pos_rows, t, cfg)
        x = _attn_mlp_tail(x, o, layer, cfg, lr, mesh)
    x = rms_norm(x, params["ln_f"])
    logits = _unembed(x, params, mesh)
    return logits, pool


@dispatch.counted("paged_decode_step_rows")
def paged_decode_step_rows(params: Params, token: torch.Tensor,
                           cfg: TransformerConfig, pool: KVCache,
                           tables: torch.Tensor, pos_rows: torch.Tensor,
                           use_kernel: bool = False, lora=None, mesh=None
                           ) -> tuple[torch.Tensor, KVCache]:
    """One paged decode step: token [B, 1], tables [B, n_pages] int32,
    pos_rows [B] -> (logits [B, vocab], pool), pool written in place.
    ``use_kernel`` selects the paged kernel read (CUDA tensors); False
    keeps the gather + ``_cached_attention`` read that is bitwise equal
    to the contiguous engine on the CPU.  ``lora`` and ``mesh`` as
    :func:`_rows_forward` takes them: under tp the kernel reads this
    rank's pool of ``H_kv/tp`` heads."""
    b, t = token.shape
    if t != 1:
        raise ValueError(f"paged_decode_step_rows is one token per "
                         f"slot, got T={t}")
    logits, pool = _paged_rows_forward(params, token, cfg, pool, tables,
                                       pos_rows, use_kernel, lora, mesh)
    return logits[:, 0], pool


@dispatch.counted("paged_window_rows")
def paged_window_rows(params: Params, tokens: torch.Tensor,
                      cfg: TransformerConfig, pool: KVCache,
                      tables: torch.Tensor, pos_rows: torch.Tensor,
                      lora=None, mesh=None) -> tuple[torch.Tensor, KVCache]:
    """Multi-token paged step: tokens [B, K+1] appended at each row's
    own position through its block table -> (logits [B, K+1, vocab],
    pool), the paged twin of :func:`decode_window_rows`.  The read is
    the dense gather (the paged kernel is single-query), so a
    speculative window launches no K2.  The caller must have reserved
    writable blocks covering [pos, pos+K] a live row; rejected rows
    past the accepted prefix are rolled back by trimming the table,
    never by rewriting the pool.  ``lora`` and ``mesh`` as
    :func:`_rows_forward` takes them."""
    return _paged_rows_forward(params, tokens, cfg, pool, tables, pos_rows,
                               use_kernel=False, lora=lora, mesh=mesh)


@dispatch.counted("paged_adopt")
def paged_adopt_blocks(pool: KVCache, one: KVCache, ids, start_block: int,
                       n_blocks: int) -> KVCache:
    """Copy rows [start_block*bs, (start_block+n_blocks)*bs) of a dense
    [1, S] cache into pool blocks ``ids`` (distinct, [n_blocks]), in
    place — how a fill's transient dense cache lands in the pool."""
    bs = pool.k[0].shape[1]
    idx = torch.as_tensor(ids, dtype=torch.long, device=pool.k[0].device)
    for dst, src in zip(pool.k + pool.v, one.k + one.v):
        rows = src[0, start_block * bs:(start_block + n_blocks) * bs]
        dst[idx] = rows.reshape(n_blocks, bs, *rows.shape[1:])
    return pool


@dispatch.counted("paged_gather")
def paged_gather_entry(pool: KVCache, ids, pos: int) -> KVCache:
    """Gather blocks ``ids`` ([n], padded with the null block) into a
    fresh dense [1, n*bs] cache with ``pos`` valid rows — the bridge
    from shared blocks to the dense prefill machinery.  The entry owns
    new tensors; the pool is untouched."""
    idx = torch.as_tensor(ids, dtype=torch.long, device=pool.k[0].device)

    def take(lst):
        out = []
        for a in lst:
            g = a[idx]
            out.append(g.reshape(1, g.shape[0] * g.shape[1],
                                 *g.shape[2:]))
        return out

    return KVCache(k=take(pool.k), v=take(pool.v), pos=int(pos))


@dispatch.counted("paged_cow_copy")
def paged_copy_block(pool: KVCache, src: int, dst: int) -> KVCache:
    """Copy-on-write: duplicate physical block ``src`` into ``dst``, in
    place, before a writer diverges from the sharers."""
    for a in pool.k + pool.v:
        a[dst].copy_(a[src])
    return pool


@dispatch.counted("paged_slab_export")
def paged_slab_from_dense(one: KVCache, n_blocks: int, block_size: int
                          ) -> tuple[list, list]:
    """Pack the first ``n_blocks * block_size`` rows of a dense [1, S]
    cache as block-shaped slabs ([n_blocks, bs, H_kv, D] a layer), the
    payload of a paged prefill export: ceil(L/bs) blocks instead of the
    [1, max_seq] cache.  The slabs own their rows."""
    def take(lst):
        return [a[0, :n_blocks * block_size].reshape(
            n_blocks, block_size, *a.shape[2:]).clone() for a in lst]

    return take(one.k), take(one.v)


@dispatch.counted("paged_slab_adopt")
def paged_adopt_slab(pool: KVCache, slab_k: list, slab_v: list, ids
                     ) -> KVCache:
    """Land a block slab in pool blocks ``ids`` (distinct, [n]), in
    place; the slab may sit on another device (a host tier's CPU
    tensors)."""
    idx = torch.as_tensor(ids, dtype=torch.long, device=pool.k[0].device)
    for dst, src in zip(pool.k + pool.v, list(slab_k) + list(slab_v)):
        dst[idx] = src.to(dst.device)
    return pool


def paged_dense_from_slab(slab_k: list, slab_v: list, pos: int,
                          max_seq: int) -> KVCache:
    """Unpack a block slab into a dense [1, max_seq] cache, zero past
    the slab's rows: the bridge from a paged export into a contiguous
    engine."""
    def take(lst):
        out = []
        for a in lst:
            rows = a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])
            dense = rows.new_zeros((1, max_seq, *a.shape[2:]))
            dense[0, :rows.shape[0]] = rows
            out.append(dense)
        return out

    return KVCache(k=take(slab_k), v=take(slab_v), pos=int(pos))


def _validated_prefill(params, prompt, cfg, n_tokens, max_seq, mesh=None):
    """Shared generation front half: bounds checks + flash prefill of a
    fresh cache (under ``mesh`` as :func:`forward_with_cache`)."""
    b, tp = prompt.shape
    max_seq = max_seq or cfg.max_seq
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
    if tp + n_tokens > max_seq:
        raise ValueError(
            f"prompt ({tp}) + n_tokens ({n_tokens}) exceeds the "
            f"{max_seq}-slot cache")
    cache = init_cache(cfg, b, max_seq, device=_device(params), mesh=mesh)
    return forward_with_cache(params, prompt, cfg, cache,
                              first_chunk=True, mesh=mesh)


@torch.no_grad()
def greedy_generate(params: Params, prompt: torch.Tensor,
                    cfg: TransformerConfig, n_tokens: int,
                    max_seq: int | None = None, mesh=None) -> torch.Tensor:
    """prompt [B, Tp] -> [B, Tp + n_tokens] greedy continuation
    (``mesh`` as :func:`forward_with_cache` takes it: every rank
    returns the same tokens)."""
    logits, cache = _validated_prefill(params, prompt, cfg, n_tokens,
                                       max_seq, mesh)
    tok = logits[:, -1].argmax(dim=-1)
    out = [tok]
    for _ in range(n_tokens - 1):
        logits, cache = forward_with_cache(params, tok[:, None], cfg,
                                           cache, mesh=mesh)
        tok = logits[:, 0].argmax(dim=-1)
        out.append(tok)
    generated = torch.stack(out, dim=1).to(prompt.dtype)
    return torch.cat([prompt, generated], dim=1)


@torch.no_grad()
def sample_generate(params: Params, prompt: torch.Tensor,
                    cfg: TransformerConfig, n_tokens: int,
                    generator: torch.Generator, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 0.0,
                    max_seq: int | None = None, mesh=None) -> torch.Tensor:
    """Temperature/top-k/top-p sampling, drawn from ``generator``;
    same structure as ``greedy_generate`` (``mesh`` too: each rank
    draws from its own generator, seeded alike, on the same whole
    logits, so every rank returns the same tokens)."""
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    logits, cache = _validated_prefill(params, prompt, cfg, n_tokens,
                                       max_seq, mesh)

    def pick(lg):
        return sample_token(lg, generator, temperature, top_k, top_p)

    tok = pick(logits[:, -1])
    out = [tok]
    for _ in range(n_tokens - 1):
        logits, cache = forward_with_cache(params, tok[:, None], cfg,
                                           cache, mesh=mesh)
        tok = pick(logits[:, 0])
        out.append(tok)
    generated = torch.stack(out, dim=1).to(prompt.dtype)
    return torch.cat([prompt, generated], dim=1)


__all__ = ["FusedBlockGraph", "KVCache", "SpecDraft", "adopt_one_slot",
           "block_length", "copy_cache", "decode_fused_rows",
           "decode_spec_fused_rows", "decode_step", "decode_step_rows",
           "decode_window_rows", "draft_ngram_rows", "draft_propose_rows",
           "draft_sample_rows", "forward_with_cache", "greedy_generate",
           "init_cache", "init_paged_pool", "ngram_propose_rows",
           "paged_adopt_blocks", "paged_adopt_slab", "paged_copy_block",
           "paged_decode_step_rows", "paged_dense_from_slab",
           "paged_gather_entry", "paged_slab_from_dense",
           "paged_window_rows", "prefill", "prefill_adopt_rows",
           "sample_generate", "sample_rows", "sample_token",
           "scatter_cache", "select_next_tokens", "spec_accept_rows",
           "suffix_fill_adopt"]
