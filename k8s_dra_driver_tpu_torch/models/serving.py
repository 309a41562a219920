"""Continuous-batching serving engine (slot-refill decode).

The port of ``k8s_dra_driver_tpu/models/serving.py``: requests of
different lengths share one fixed-size decode batch, and when a
sequence finishes its SLOT is refilled from the queue instead of
draining the whole batch.  The scheduling is the reference's, step for
step, so token streams match the JAX engine's:

- **Batched refill rounds.**  Free slots are filled in rounds; fresh
  prompts are grouped by length and prefilled together through the
  flash kernel (``prefill_adopt_rows``), prefix-cache hits adopt their
  remembered rows and prefill only the suffix (``suffix_fill_adopt``),
  and each round's first tokens come back in one readback.
  ``prefill_chunk=C`` instead feeds each prompt in C-token chunks.
- **One decode step for all slots**: ``decode_step_rows`` with
  per-row positions; slot occupancy is data.
- **Greedy or sampled decode per request** (``temperature``/``seed``
  on the Request, engine-level ``top_k``/``top_p``), EOS + per-request
  ``max_new`` + cache-capacity stops.  Each sampled request draws from
  its own ``torch.Generator`` seeded with ``seed`` (per-slot
  generators), so its tokens do not depend on the batch or the
  schedule — preemption reruns included.  They cannot match the JAX
  engine's ``jax.random`` streams.
- **Automatic prefix caching** (``prefix_cache=N``): fills' and
  finishes' K/V rows are remembered and a new request adopts its
  longest remembered prefix.
- **Paged KV cache** (``kv_layout="paged"``): the cache becomes a
  block pool owned by the refcounted host ledger (serving_kv/), each
  slot reads through a block table, prefix reuse is copy-on-write
  block sharing, and exhaustion escalates evict-cold ->
  preempt-and-requeue.  On the card the decode read goes through the
  paged kernel by default (``kv_kernel``).
- **Fused generation blocks** (``chain_steps=K > 1``, contiguous KV):
  each engine step is one block of up to K decode steps with sampling,
  KV writes and per-row EOS / budget stops on the device
  (``decode_fused_rows``), the refill of freed slots overlapping it,
  and one packed readback.  On the CPU the block is a loop with an
  early exit; on the card it is one replay of a captured CUDA graph
  (``FusedBlockGraph``), with no fallback.  Tokens equal the
  step-at-a-time engine's.
- **Speculative continuous batching** (``draft_params``/``draft_cfg``/
  ``draft_len``, or the model-free ``draft_source="ngram"`` prompt
  lookup): each step a draft proposes ``draft_len`` tokens a slot, the
  target scores the whole window in one forward
  (``decode_window_rows``; ``paged_window_rows`` on the paged layout,
  n-gram source only) and each row emits its accepted prefix plus a
  correction.  Greedy rows accept by exact match, so their tokens
  equal the non-speculative engine's; sampled rows accept by rejection
  sampling (``spec_accept_rows``), each draft drawing from its own
  draft-side generator.  Paged rollback trims the window's scratch
  blocks off the table (``_kv_spec_trim``).  With ``chain_steps > 1``
  each step is one fused block of up to K windows
  (``decode_spec_fused_rows``; on the card one graph replay).
- **Multi-adapter LoRA** (``adapter_pool=AdapterPool(...)``,
  serving_lora/, ``Request(adapter=name)``): rows of different adapters
  share every decode batch, each adding its adapter's wq/wo deltas by
  pool slot id (slot 0, the null adapter, for base rows).  A slot pins
  its adapter from its fill to its finish, cancel or preemption; each
  refill round admits only the distinct adapters the pool can seat.
  Prefill stays base-model, so fills, prompt K/V and prefix entries are
  adapter-independent; only base requests seed the prefix store at
  finish.  In fused blocks the graphs read the pool's buffers and the
  slot ids at fixed addresses, so binds never recapture.

- **Disaggregated prefill/decode**: ``prefill_export`` prefills a
  request without taking a slot and returns a :class:`KVBlock` (the
  prompt's K/V, the first token and, for a sampled request, its
  generator's state after the first draw); ``adopt_block`` lands the
  block in a free slot of another engine, which continues exactly as a
  local fill would have.  A paged engine exports a block-shaped
  :class:`PagedKVSlab` (ceil(L/bs) blocks); every layout pair adopts.
  ``export_prefix`` / ``import_prefix`` move one prefix-store entry
  between engines as a dense [1, S] cache.
- **KV tiers** (``kv_host_bytes`` / ``kv_spill_dir``, paged layout):
  the prefix store's eviction demotes entries to a host-memory arena
  and a crc-checked spill directory, and a hit on a demoted entry
  promotes it back into fresh blocks (serving_kv/tiers.py); a fresh
  engine over the same directory re-adopts what an earlier one spilled.
- **Tensor parallelism** (``mesh=``, a ``parallel.mesh.ProcessMesh``):
  ``params`` (and ``draft_params``) are this rank's
  ``transformer.shard_params`` blocks, as the JAX engine serves
  ``shard_params`` weights; the cache, the block pool, the draft cache
  and every transient fill cache hold this rank's ``H_kv/tp`` KV heads
  (``decode.init_cache`` / ``init_paged_pool`` under the mesh), every
  row call passes the mesh (steps, windows, drafts, fills, fused
  blocks), prefix entries hold local heads, and an adapter pool is read
  through views of this rank's cut of its buffers
  (``serving_lora.pool.shard_lora_buffers(..., copy=False)``, taken
  once: the pool's loads write the buffers in place).  The logits are whole on every rank and each slot's generators
  are seeded alike, so every rank schedules, samples and finishes the
  same.  Fused blocks run step by step (``decode_fused_rows``) under a
  mesh: no ``FusedBlockGraph`` is built, since gloo's host-staged
  collectives cannot be captured.  Under tp the KV tiers and the
  disaggregation verbs (``prefill_export``, ``adopt_block``,
  ``export_prefix``, ``import_prefix``) raise ``NotImplementedError``
  naming ROADMAP's item (``decode._tp_later``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from ..serving_kv import (NULL_BLOCK, BlocksExhausted, KVBlockManager,
                          PagedPrefixStore, PrefixListeners, TieredKVStore,
                          kv_bytes_per_token)
from ..serving_lora.pool import shard_lora_buffers
from ..utils import dispatch
from ..utils.device import resolve_device
from . import decode as _decode
from .decode import (KVCache, decode_step_rows, decode_window_rows,
                     draft_ngram_rows, draft_propose_rows,
                     draft_sample_rows, init_cache, sample_token,
                     spec_accept_rows)
from .transformer import TransformerConfig, unstage_params


@dataclasses.dataclass
class Request:
    uid: Any
    prompt: np.ndarray              # [L] int32
    max_new: int
    eos_id: int | None = None
    # temperature > 0 samples this request from a generator seeded
    # with ``seed``; 0 = greedy.  top_k/top_p are engine-level.
    temperature: float = 0.0
    seed: int = 0
    # adapter name (a manifest of the engine's AdapterPool), None = base
    # model.  Prefill stays base-model (prompt K/V and prefix shares stay
    # adapter-independent); the adapter engages from the first decode
    # step on.
    adapter: str | None = None


@dataclasses.dataclass
class Finished:
    uid: Any
    tokens: np.ndarray              # prompt + generated
    # prompt length, so consumers (stream()) can split generated
    # tokens out of ``tokens`` without re-holding the Request
    n_prompt: int = 0


@dataclasses.dataclass
class KVBlock:
    """One prefilled prompt's exportable K/V state: the unit of the
    prefill -> decode handoff.

    ``kv`` holds the prompt's K/V: a [1, S] :class:`KVCache` (``pos`` =
    prompt length) from a contiguous engine, a :class:`PagedKVSlab`
    from a paged one.  ``first`` is the first generated token (the
    fill's output).  ``carry`` is, for a sampled request, the state of
    its generator after the first draw (``torch.Generator.get_state()``
    of a generator on the exporter's device, seeded with the request's
    seed as a local fill seeds it), None for a greedy one: the adopter
    sets it on its slot generator, so the request continues the stream a
    local fill would have drawn.  ``reused_tokens`` counts prompt tokens
    taken from the exporter's prefix store instead of computed."""

    request: Request
    kv: Any
    first: int
    carry: torch.Tensor | None = None
    reused_tokens: int = 0


@dataclasses.dataclass
class PagedKVSlab:
    """Block-shaped K/V payload of a paged export: per-layer
    [ceil(L/bs), bs, H_kv, D] slabs holding exactly the prompt's blocks,
    ``pos`` = prompt length.  A paged adopter lands the blocks in its
    pool and inserts them into its prefix store, so the prefix arrives
    already shared (slot and store refcount the same blocks)."""

    k: list
    v: list
    pos: int
    block_size: int


@dispatch.counted("sample_one")
def _sample_one(logits, generator, temperature, top_k: int, top_p: float):
    """Refill-path first-token draw (the paged fills)."""
    return sample_token(logits, generator, temperature, top_k, top_p)


@dispatch.counted("next_tokens")
def _next_tokens(logits, generators, temps, top_k: int, top_p: float):
    """[B,V] logits + per-slot generators + [B] temps -> next [B]: the
    shared ``select_next_tokens`` merge."""
    return _decode.select_next_tokens(logits, generators, temps, top_k,
                                      top_p)


def _overlap(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the common leading token run of two prompts."""
    n = min(a.size, b.size)
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class PrefixCache(PrefixListeners):
    """LRU store of prompt-prefix K/V (automatic prefix caching).

    Entries map a prompt's token tuple to the [1, max_seq] ``KVCache``
    its fill produced (``pos`` = prompt length); a later request adopts
    the longest common prefix: the fill clones the entry, lowers
    ``pos`` to the match length ``p`` and prefills only the suffix.
    Correct because position-masked attention never reads rows >= pos
    and the suffix rewrites [p, L).  Reuse is therefore exactly chunked
    prefill with the first chunk memoized, so cached and uncached
    engines generate identical tokens.

    Memory: each entry retains a full cache row (~one extra slot), which
    is why the store is small and LRU-bounded (``entries``).

    The listener lists (:class:`~..serving_kv.prefix.PrefixListeners`)
    fire at the reference's points: hit and miss in
    ``longest_prefix``, insert, evict and drop.
    """

    def __init__(self, entries: int):
        if entries < 1:
            raise ValueError("prefix cache needs >= 1 entry")
        super().__init__()
        self.entries = entries
        # dict insertion order IS the LRU order (oldest first)
        self._store: dict[tuple, KVCache] = {}
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        # bytes of K/V adopted instead of recomputed: tokens_reused x
        # the per-token row cost, measured once from a real entry
        self.bytes_reused = 0
        self.bytes_per_token = 0

    def _touch(self, key: tuple) -> None:
        self._store[key] = self._store.pop(key)

    def _best_match(self, prompt: np.ndarray) -> tuple[int, tuple]:
        """(p, key) of the longest common prefix over all entries,
        capped at len(prompt)-1 so the last prompt token is always
        re-prefilled (its logits seed generation)."""
        toks = prompt.tolist()
        cap = len(toks) - 1
        best_p, best_key = 0, None
        for key in self._store:
            p = 0
            for a, b in zip(key, toks[:cap]):
                if a != b:
                    break
                p += 1
            if p > best_p:
                best_p, best_key = p, key
        return best_p, best_key

    def peek(self, prompt: np.ndarray) -> int:
        """Longest match length WITHOUT hit accounting or an LRU
        touch."""
        return self._best_match(prompt)[0]

    def longest_prefix(self, prompt: np.ndarray
                       ) -> tuple[int, KVCache | None]:
        """(p, entry) for the longest remembered prefix; counts the
        hit and refreshes the entry's LRU position."""
        best_p, best_key = self._best_match(prompt)
        if best_key is None:
            self.misses += 1
            self._notify_stats("miss", 0, 0)
            return 0, None
        self.hits += 1
        self.tokens_reused += best_p
        self.bytes_reused += best_p * self.bytes_per_token
        self._notify_stats("hit", best_p, best_p * self.bytes_per_token)
        self._touch(best_key)
        return best_p, self._store[best_key]

    def entry(self, tokens: np.ndarray) -> KVCache | None:
        """The entry for EXACTLY ``tokens``, or None.  Refreshes its LRU
        position (a remote fetch is a use) but counts no hit: reuse is
        counted where the tokens are adopted."""
        key = tuple(np.asarray(tokens).tolist())
        if key not in self._store:
            return None
        self._touch(key)
        return self._store[key]

    def insert(self, tokens: np.ndarray, filled: KVCache) -> None:
        """Remember a [1, S] cache whose first ``len(tokens)`` rows are
        the K/V of ``tokens``.  The cache must own its tensors (no
        engine tensor may alias them)."""
        if not self.bytes_per_token:
            self.bytes_per_token = kv_bytes_per_token(
                filled.tensors(), filled.k[0].shape[1])
        key = tuple(tokens.tolist())
        self._store.pop(key, None)            # re-insert = most recent
        self._store[key] = filled
        self._notify("insert", key)
        while len(self._store) > self.entries:
            evicted = next(iter(self._store))
            self._store.pop(evicted)
            self._notify("evict", evicted)

    def drop(self, tokens: np.ndarray) -> None:
        """Forget an entry (no-op if absent) — used when a finish
        capture strictly dominates its fill-time prompt entry."""
        key = tuple(tokens.tolist())
        if self._store.pop(key, None) is not None:
            self._notify("drop", key)


@dispatch.counted("extract_slot")
def _extract_slot(cache: KVCache, slot: int, pos: int) -> KVCache:
    """Copy row ``slot`` of the engine cache (scales included) out as a
    fresh [1, S] cache with ``pos`` tokens valid (a prefix-cache
    entry); later in-place decode writes cannot reach it."""
    def take(lst):
        return None if lst is None else [a[slot:slot + 1].clone()
                                         for a in lst]

    return KVCache(k=take(cache.k), v=take(cache.v), pos=int(pos),
                   k_scale=take(cache.k_scale), v_scale=take(cache.v_scale))


@dispatch.counted("adopt_slot")
def _adopt_slot(cache: KVCache, one: KVCache, slot: int) -> KVCache:
    """Copy a freshly prefilled [1, S] cache into row ``slot`` of the
    engine cache, in place."""
    return _decode.adopt_one_slot(cache, one, slot)


#: the suffix continuation of a prefix-adopted fill under its own
#: dispatch label: "prefill" counts fresh prompt compute,
#: "prefill_suffix" suffix-only compute after prefix adoption
_prefill_suffix = dispatch.counted("prefill_suffix")(
    _decode.forward_with_cache)

#: draft-model prompt fills under their own label, so draft work is
#: attributable apart from the target's
_draft_prefill = dispatch.counted("draft_prefill")(
    _decode.forward_with_cache)

#: a sampled request's draft-side generator is seeded with its seed
#: XOR this constant.  Not the request's seed itself: the target
#: generator is seeded with that, and equal streams would tie each
#: proposal's draws to the acceptance draws that judge it, which breaks
#: rejection sampling's guarantee (the JAX engine derives its draft key
#: by ``fold_in(key, 7919)`` for the same reason)
_DRAFT_SEED_SALT = 0x9E3779B97F4A7C15


def _kv_to(kv, device: torch.device):
    """A block's K/V (``KVCache`` or ``PagedKVSlab``) with every tensor
    on ``device``; tensors already there are kept as they are."""
    def move(lst):
        return None if lst is None else [t.to(device) for t in lst]

    if isinstance(kv, PagedKVSlab):
        return dataclasses.replace(kv, k=move(kv.k), v=move(kv.v))
    return dataclasses.replace(kv, k=move(kv.k), v=move(kv.v),
                               k_scale=move(kv.k_scale),
                               v_scale=move(kv.v_scale))


class ServingEngine:
    """Continuous-batching engine over ``slots`` cache rows: greedy by
    default, per-request sampling via ``Request(temperature=...,
    seed=...)``.  ``params`` must live on ``device`` (default the
    card).  ``mesh``: serve this rank's ``shard_params`` blocks over a
    process mesh (module docstring, "Tensor parallelism"); every mode
    runs under it but the KV tiers and the disaggregation verbs under
    tp."""

    def __init__(self, params, cfg: TransformerConfig, slots: int,
                 max_seq: int | None = None,
                 prefill_chunk: int | None = None,
                 top_k: int = 0, top_p: float = 0.0,
                 prefix_cache: int = 0,
                 draft_params=None,
                 draft_cfg: TransformerConfig | None = None,
                 draft_len: int = 4,
                 draft_source: str | None = None,
                 chain_steps: int = 1,
                 kv_layout: str = "contiguous",
                 kv_block_size: int = 16,
                 kv_blocks: int | None = None,
                 kv_kernel: bool | None = None,
                 kv_host_bytes: int | None = None,
                 kv_spill_dir=None,
                 adapter_pool=None,
                 device="cuda", mesh=None):
        _decode._refuse_tp(cfg, mesh, params)
        if _decode._tp(mesh) and (kv_host_bytes or kv_spill_dir):
            _decode._tp_later("the KV tiers (kv_host_bytes, kv_spill_dir)")
        if "stages" in params:
            # a pp-trained checkpoint serves on one device
            params = unstage_params(params, cfg)
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self._paged = kv_layout == "paged"
        if (kv_host_bytes or kv_spill_dir) and not self._paged:
            # tiering demotes block-shaped slabs; the contiguous cache
            # has no block ledger to demote from
            raise ValueError("KV tiering (kv_host_bytes/kv_spill_dir) "
                             "requires kv_layout='paged'")
        if self._paged:
            if draft_params is not None:
                # the n-gram source needs no draft KV; a draft model
                # would need its own paged cache
                raise ValueError("paged KV composes with the n-gram "
                                 "draft source only; use "
                                 "draft_source='ngram'")
            if chain_steps > 1:
                raise ValueError("paged KV does not compose with "
                                 "fused generation blocks")
            if cfg.kv_cache_dtype == "int8":
                raise ValueError("paged KV does not support the "
                                 "int8 cache")
            if cfg.attention_window:
                raise ValueError("paged KV does not support "
                                 "windowed attention")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {top_p}")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("draft_params and draft_cfg go together")
        if draft_params is not None and draft_len < 1:
            raise ValueError("draft_len must be >= 1")
        if chain_steps < 1:
            raise ValueError("chain_steps must be >= 1")
        if draft_source not in (None, "model", "ngram"):
            raise ValueError(f"unknown draft_source {draft_source!r}")
        if draft_source == "model" and draft_params is None:
            raise ValueError("draft_source='model' needs draft_params")
        if draft_source == "ngram" and draft_params is not None:
            raise ValueError("draft_source='ngram' is model-free; "
                             "drop draft_params")
        if draft_source == "ngram" and draft_len < 1:
            raise ValueError("draft_len must be >= 1")
        if adapter_pool is not None:
            pc = adapter_pool.cfg
            if ((pc.n_layers, pc.d_model, pc.n_heads, pc.d_head)
                    != (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head)):
                raise ValueError("adapter pool is laid out for a "
                                 "different model shape")
        self.device = resolve_device(device)
        if (adapter_pool is not None
                and adapter_pool.device != self.device):
            raise ValueError(f"the adapter pool lives on "
                             f"{adapter_pool.device}, the engine runs on "
                             f"{self.device}")
        for name, tree in (("params", params), ("draft_params",
                                                 draft_params)):
            if tree is not None and tree["embed"].device != self.device:
                raise ValueError(
                    f"{name} live on {tree['embed'].device}, the engine "
                    f"runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.mesh = mesh
        self.slots = slots
        self._prefix = (PrefixCache(prefix_cache)
                        if prefix_cache and not self._paged else None)
        self.prefill_chunk = prefill_chunk
        self.top_k = top_k
        self.top_p = top_p
        self.chain_steps = chain_steps
        # speculative continuous batching: a draft proposes draft_len
        # tokens a slot (the draft model's loop or the prompt n-gram
        # gather), the target scores the whole window in one forward;
        # greedy rows accept by exact match, sampled rows by rejection
        # sampling, both in one batch
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.draft_len = draft_len
        self._draft_source = draft_source or (
            "model" if draft_params is not None else None)
        self._ngram = self._draft_source == "ngram"
        self._spec_on = self._draft_source is not None
        self._spec_windows = 0
        self._spec_accepted = 0
        # proposals made for LIVE rows (draft_len a row a window), the
        # accept rate's denominator; _spec_accepted counts only drafts
        # actually emitted, so the rate is conservative
        self._spec_drafts = 0
        # per-phase host accounting (stats())
        self._time_prefill = 0.0
        self._time_decode = 0.0
        self._time_host = 0.0
        self.max_seq = max_seq or cfg.max_seq
        if self._ngram:
            # each slot's prompt context for the n-gram lookup: a host
            # array and its device twin, rebuilt when a fill changes it
            # (the fused block's graphs upload it into a fixed buffer
            # instead).  Zeros with length 0 never match, so a freed
            # slot's stale context is inert.
            self._ngram_ctx = np.zeros((slots, self.max_seq), np.int32)
            self._ngram_len = np.zeros(slots, np.int32)
            self._ngram_dev = None
        if self._paged:
            if self.max_seq % kv_block_size:
                # blocks_per_slot = max_seq // bs keeps the gathered
                # dense view's shape IDENTICAL to the contiguous
                # cache — the bitwise-equality invariant
                raise ValueError(
                    f"max_seq {self.max_seq} is not a multiple of "
                    f"kv_block_size {kv_block_size}")
            self._kv_bs = kv_block_size
            self._kv_tw = self.max_seq // kv_block_size  # table width
            if kv_blocks is None:
                # memory parity with the contiguous cache (+ null block)
                kv_blocks = slots * self._kv_tw + 1
            if kv_blocks - 1 < self._kv_tw:
                raise ValueError(
                    f"kv_blocks {kv_blocks} cannot hold one full "
                    f"{self.max_seq}-token sequence "
                    f"({self._kv_tw} blocks + the null block)")
            self.kv_manager = KVBlockManager(kv_blocks, kv_block_size)
            self.pool = _decode.init_paged_pool(cfg, kv_blocks,
                                                kv_block_size,
                                                device=self.device,
                                                mesh=mesh)
            self.cache = None        # no contiguous cache in paged mode
            self._table = np.zeros((slots, self._kv_tw), np.int32)
            # device mirror of _table, rebuilt only when a table row
            # changes (fills, boundary appends, CoW copies, releases)
            self._table_dev = None
            # one-entry memo of the last store-gathered dense prefix:
            # KV rows for a token prefix are a pure function of
            # (params, cfg, tokens), so a snapshot can never go stale
            self._kv_dense_memo: tuple | None = None
            self._slot_blocks: list[list[int]] = [[] for _ in
                                                  range(slots)]
            if kv_host_bytes or kv_spill_dir:
                # eviction demotes to host memory / disk, and a hit on a
                # demoted entry promotes it through the halves bound here
                self._prefix = TieredKVStore(
                    prefix_cache or max(2 * slots, 4), self.kv_manager,
                    host_bytes=kv_host_bytes or 0, spill_dir=kv_spill_dir)
                self._prefix.bind_engine(self._tier_gather,
                                         self._tier_adopt)
            else:
                self._prefix = PagedPrefixStore(
                    prefix_cache or max(2 * slots, 4), self.kv_manager)
            self._prefix.bytes_per_token = kv_bytes_per_token(
                self.pool.tensors(), kv_blocks * kv_block_size)
            # the kernel read on the card by default, as the JAX engine
            # turns its kernel on by default on the TPU
            self._kv_use_kernel = (kv_kernel if kv_kernel is not None
                                   else self.device.type == "cuda")
            self._kv_preemptions = 0
        else:
            self.cache = init_cache(cfg, slots, self.max_seq,
                                    device=self.device, mesh=mesh)
        self.queue: deque[Request] = deque()
        # host-side slot state; None = free
        self._req: list[Request | None] = [None] * slots
        self._pos = np.zeros(slots, np.int32)       # fill depth
        self._generated: list[list[int]] = [[] for _ in range(slots)]
        self._last = np.zeros(slots, np.int32)      # next input token
        # per-slot sampling state: one persistent generator per slot,
        # reseeded with each sampled request's seed at its fill (the
        # fused block's graphs hold them; greedy rows never draw from
        # theirs outside the block), and the temperatures (0 = greedy)
        self._slot_gens = [torch.Generator(device=self.device)
                           for _ in range(slots)]
        self._temps = np.zeros(slots, np.float32)
        # a draft model's cache and its draft-side generators, one a
        # slot, apart from the target's (reseeded at each sampled fill)
        self._draft_cache = (init_cache(draft_cfg, slots, self.max_seq,
                                        device=self.device, mesh=mesh)
                             if draft_params is not None else None)
        self._draft_gens = ([torch.Generator(device=self.device)
                             for _ in range(slots)]
                            if draft_params is not None else None)
        # multi-adapter serving (serving_lora/): per-slot pins into the
        # shared AdapterPool.  _adapter_slot is the host mirror of the
        # per-row pool slot ids the decode functions gather with (0 =
        # the null adapter); _lora_dev is its device twin for the step
        # path, rebuilt after a bind or release changed it.  The fused
        # block's graphs upload the mirror into their own fixed buffer
        # with every block instead.
        self.adapter_pool = adapter_pool
        self._adapter: list[str | None] = [None] * slots
        self._adapter_slot = np.zeros(slots, np.int64)
        self._lora_dev = None
        # the buffers the rows read: under a mesh, views of this rank's
        # cut (the pool's loads write in place, so they show through)
        self._lora_layers = (
            None if adapter_pool is None
            else adapter_pool.buffers if mesh is None
            else shard_lora_buffers(adapter_pool.buffers, mesh, copy=False))
        # the fused block on the card: captured CUDA graphs over this
        # engine's parameters, caches and generators (never under a
        # mesh: the blocks run step by step there)
        self._graphs = None
        if chain_steps > 1 and self.device.type == "cuda" and mesh is None:
            draft = (_decode.SpecDraft(draft_len, draft_params, draft_cfg,
                                       self._draft_cache, self._draft_gens)
                     if self._spec_on else None)
            self._graphs = _decode.FusedBlockGraph(
                params, cfg, self.cache, self._slot_gens, chain_steps,
                top_k, top_p, draft,
                None if adapter_pool is None else adapter_pool.buffers)
        # lifetime counters (stats())
        self._finished_total = 0
        self._cancelled = 0
        self._tokens_total = 0
        self._steps_total = 0
        # blocks exported (prefill role) and adopted (decode role)
        self._exports = 0
        self._adoptions = 0

    # -- request intake --------------------------------------------------

    def _check_request(self, req: Request) -> Request:
        """Shape/capacity validation; returns the request with its
        prompt normalized to int32."""
        prompt = np.asarray(req.prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D array")
        if req.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {req.max_new}")
        if getattr(req, "adapter", None) is not None:
            # adapters are registered before traffic names them: an
            # unknown name would otherwise fail at its cold load, mid-batch
            if self.adapter_pool is None:
                raise ValueError(
                    f"request {req.uid!r} names adapter {req.adapter!r} "
                    f"but this engine has no adapter pool")
            if not self.adapter_pool.known(req.adapter):
                raise ValueError(
                    f"unknown adapter {req.adapter!r} (register its "
                    f"manifest with the pool first)")
        # a speculative window's first write is the last emitted token's
        # own row; only the draft_len proposal rows lie past it, so that
        # is the scratch margin.  The fused speculative block needs one
        # row more: frozen rows ride along inside the block and their
        # windows write [pos, pos + draft_len] past the finish line,
        # where the step path releases a finished slot first.  The plain
        # fused block needs none: frozen rows never write past it.
        margin = ((self.draft_len + (1 if self.chain_steps > 1 else 0))
                  if self._spec_on else 0)
        if prompt.size + req.max_new + margin > self.max_seq:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({req.max_new})"
                + (f" + scratch margin ({margin})" if margin else "")
                + f" exceeds the {self.max_seq}-slot cache")
        if self._paged:
            # a request that can NEVER fit the pool must be refused at
            # intake, not discovered as a livelock under preemption (the
            # window's scratch blocks count: they are held until the
            # trim after the accept)
            worst = min(prompt.size + req.max_new + margin, self.max_seq)
            need = -(-worst // self._kv_bs)
            if need > self.kv_manager.n_blocks - 1:
                raise ValueError(
                    f"request needs {need} KV blocks at its longest; "
                    f"the pool holds {self.kv_manager.n_blocks - 1}")
        return dataclasses.replace(req, prompt=prompt)

    def submit(self, req: Request) -> None:
        req = self._check_request(req)
        if any(r.uid == req.uid for r in self.queue) or any(
                r is not None and r.uid == req.uid for r in self._req):
            # uid is the cancel/finished-stream handle
            raise ValueError(f"uid {req.uid!r} already in flight")
        self.queue.append(req)

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._req)

    @property
    def pending(self) -> int:
        return len(self.queue)

    # -- pool-facing API -------------------------------------------------

    def enqueue(self, req: Request) -> None:
        """Pool-facing name for :meth:`submit`."""
        self.submit(req)

    def occupancy(self) -> dict:
        """Scheduling snapshot for a router: slot/queue depth plus
        per-active-request generated-token counts; paged engines add
        free/total blocks and reclaimable headroom, speculative engines
        their draft accept rate, adapter engines their residency."""
        out = {
            "slots": self.slots,
            "active": self.active,
            "pending": self.pending,
            "free_slots": self.slots - self.active,
            "depth": self.active + self.pending,
            "tokens": {r.uid: len(self._generated[s])
                       for s, r in enumerate(self._req)
                       if r is not None},
        }
        if self._paged:
            view = self.kv_manager.view()
            out["kv_block_size"] = self._kv_bs
            out["kv_total_blocks"] = view["total_blocks"]
            out["kv_free_blocks"] = view["free_blocks"]
            out["kv_cow_shared_blocks"] = view["cow_shared_blocks"]
            out["kv_headroom_blocks"] = (
                view["free_blocks"] + self._prefix.evictable_count())
        if self._spec_on:
            # the router's accept-aware signal: EWMA'd by the gateway
            # (gateway/frontend.py), decile-bucketed in its spill key
            out["spec_accept_rate"] = self._spec_accept_rate()
        if self.adapter_pool is not None:
            # the residency signal a router reads: which adapters are warm
            # here, and how many pool slots a new one could claim without
            # blocking (free + evictable)
            pool = self.adapter_pool
            out["adapter_resident"] = list(pool.resident())
            out["adapter_pool_slots"] = pool.n_resident
            out["adapter_free_slots"] = pool.ledger.free
            out["adapter_headroom_slots"] = pool.headroom_slots()
        return out

    def _spec_accept_rate(self) -> float:
        """Accepted over proposed drafts so far, as the reference rounds
        it."""
        return round(self._spec_accepted / max(1, self._spec_drafts), 4)

    def prefix_peek(self, prompt) -> int:
        """Longest prompt prefix this engine's prefix store holds,
        WITHOUT hit accounting or an LRU touch — 0 when it is off."""
        if self._prefix is None:
            return 0
        return self._prefix.peek(np.asarray(prompt, np.int32))

    def prefix_residency(self, prompt) -> tuple[int, str | None]:
        """``(p, tier)`` of the longest held prefix across every storage
        tier, ``tier`` in {"device", "host", "disk", None}.
        ``prefix_peek`` stays device-only, so the admission arithmetic
        keeps its conservative block counts; this is the router's
        tier-preference signal."""
        if self._prefix is None:
            return 0, None
        prompt = np.asarray(prompt, np.int32)
        if isinstance(self._prefix, TieredKVStore):
            return self._prefix.residency(prompt)
        p = self._prefix.peek(prompt)
        return p, ("device" if p else None)

    # -- disaggregated prefill/decode ------------------------------------
    #
    # A prefill engine computes a prompt's K/V and exports it as a
    # KVBlock; a decode engine adopts the block into a free slot.  Both
    # verbs use the fills' own machinery (the prefill chunks, the
    # in-place slot and block writes, the per-request generator seeded
    # as _generator seeds it), so a request split across two engines
    # runs the computations one engine would have run.

    def _refuse_tp_verb(self, verb: str) -> None:
        """A disaggregation verb under tp: a block of this rank's heads
        is no engine's whole K/V."""
        if _decode._tp(self.mesh):
            _decode._tp_later(f"the disaggregation verb {verb}")

    def prefill_export(self, req: Request) -> KVBlock:
        """Prefill ``req`` on a standalone [1, S] cache and return its
        :class:`KVBlock` without occupying a slot.  A prefix-store hit
        adopts the remembered rows and computes only the suffix (the
        ``prefill_suffix`` dispatch label).  The first token is drawn
        here and read back (one readback an export)."""
        self._refuse_tp_verb("prefill_export")
        req = self._check_request(req)
        with torch.no_grad():
            if self._paged:
                return self._kv_prefill_export(req)
            t0 = time.perf_counter()
            start = 0
            if self._prefix is not None:
                p, hit = self._prefix.longest_prefix(req.prompt)
                if p > 0:
                    start = p
                    one = _decode.copy_cache(hit, p)
            if start == 0:
                one = init_cache(self.cfg, 1, self.max_seq,
                                 device=self.device, mesh=self.mesh)
            logits, one = self._export_fill(req, one, start)
            if self._prefix is not None:
                self._prefix.insert(req.prompt, one)
            return self._export_block(req, one, logits, start, t0)

    def _export_fill(self, req: Request, one: KVCache, start: int):
        """The export's prompt fill from row ``start`` of ``one``, in
        ``prefill_chunk``-token chunks: (last chunk's logits, cache)."""
        fill = _prefill_suffix if start > 0 else _decode._prefill
        c = self.prefill_chunk or req.prompt.size
        # the chunk loop is one phase on a trace (utils/dispatch.py
        # annotated; a no-op unless annotations are on)
        with dispatch.annotated("prefill_export"):
            for off in range(start, req.prompt.size, c):
                logits, one = fill(self.params,
                                   self._prompt(req, off, off + c)[None],
                                   self.cfg, one, off == 0, mesh=self.mesh)
        return logits, one

    def _export_block(self, req: Request, kv, logits, start: int,
                      t0: float) -> KVBlock:
        """Draw the first token as a local fill would (a generator on
        this device seeded with the request's seed), read it back, and
        wrap the block with the generator's state after the draw."""
        gen = (torch.Generator(device=self.device).manual_seed(
            int(req.seed)) if req.temperature > 0 else None)
        first = int(self._first_token(logits, req, gen))
        dispatch.record_readback("prefill_export")
        self._exports += 1
        self._time_prefill += time.perf_counter() - t0
        return KVBlock(request=req, kv=kv, first=first,
                       carry=None if gen is None else gen.get_state(),
                       reused_tokens=start)

    def adopt_block(self, block: KVBlock) -> int:
        """Adopt an exported block into a free slot; returns the slot.
        Raises RuntimeError when no slot (or no adapter slot) is free
        and ValueError on a duplicate uid, a request this engine cannot
        hold or a block it cannot read, each before any state changes.
        The slot continues from the block's first token exactly as if
        this engine had filled it; tensors on another device are copied
        to this engine's."""
        self._refuse_tp_verb("adopt_block")
        if self.draft_params is not None:
            # the block carries target K/V only; a speculative engine
            # would propose from an empty draft cache
            raise ValueError("draft engines cannot adopt KV blocks")
        req = self._check_request(block.request)
        if any(r.uid == req.uid for r in self.queue) or any(
                r is not None and r.uid == req.uid for r in self._req):
            raise ValueError(f"uid {req.uid!r} already in flight")
        slot = next((s for s in range(self.slots)
                     if self._req[s] is None), None)
        if slot is None:
            raise RuntimeError("no free decode slot to adopt into")
        if (self.adapter_pool is not None and req.adapter is not None
                and not self.adapter_pool.can_admit(req.adapter)):
            # _fill_finalize's acquire must be infallible: a pool that
            # cannot seat the adapter refuses the block untouched
            raise RuntimeError("no adapter slot to adopt into")
        if req.temperature > 0:
            if block.carry is None:
                raise ValueError("sampled block without a carried key")
            if (block.carry.numel()
                    != self._slot_gens[slot].get_state().numel()):
                # mt19937 (CPU) and Philox (CUDA) states do not convert
                raise ValueError(
                    f"the block's generator state comes from another "
                    f"device type than this engine's ({self.device.type})")
        kv = block.kv
        if self._paged and isinstance(kv, PagedKVSlab):
            nb = -(-req.prompt.size // self._kv_bs)
            if kv.block_size != self._kv_bs:
                raise ValueError(
                    f"slab block size {kv.block_size} != engine "
                    f"block size {self._kv_bs}")
            if kv.k[0].shape[0] != nb:
                raise ValueError(
                    f"slab holds {kv.k[0].shape[0]} blocks, prompt "
                    f"needs {nb}")
        t0 = time.perf_counter()
        kv = _kv_to(kv, self.device)
        if isinstance(kv, PagedKVSlab) and not self._paged:
            # cross-layout bridge: a paged exporter feeding a contiguous
            # engine unpacks to the dense cache
            kv = _decode.paged_dense_from_slab(kv.k, kv.v, kv.pos,
                                               self.max_seq)
        if self._paged:
            self._kv_adopt_into(slot, kv, req)
        else:
            # in place: a fused engine's graphs hold this cache
            self.cache = _adopt_slot(self.cache, kv, slot)
            if self._prefix is not None:
                # the migrated prompt K/V is a local entry now
                self._prefix.insert(req.prompt, kv)
        self._occupy(slot, req)
        if req.temperature > 0:
            # by value: the fused block's graphs hold this generator
            self._slot_gens[slot].set_state(block.carry)
        self._fill_finalize(slot, block.first)
        self._adoptions += 1
        self._time_prefill += time.perf_counter() - t0
        return slot

    def export_prefix(self, tokens) -> KVCache | None:
        """The prefix store's entry for EXACTLY ``tokens`` as a dense
        [1, S] cache (a paged engine gathers its blocks; a demoted entry
        is promoted first), or None when this engine does not hold it.
        No hit is counted: reuse is counted where the tokens are
        adopted."""
        self._refuse_tp_verb("export_prefix")
        if self._prefix is None:
            return None
        entry = self._prefix.entry(np.asarray(tokens, np.int32))
        if entry is None or not self._paged:
            return entry
        return self._kv_entry_dense(entry, entry.length)

    def import_prefix(self, tokens, entry: KVCache) -> None:
        """Adopt a migrated prefix entry into the local prefix store, so
        the next fill of a ``tokens``-prefixed prompt hits here.  A
        paged engine copies the rows into freshly allocated blocks owned
        by the store; when no blocks can be had the import is skipped
        (the fill then computes locally)."""
        self._refuse_tp_verb("import_prefix")
        if self._prefix is None:
            raise ValueError("prefix cache is off on this engine")
        tokens = np.asarray(tokens, np.int32)
        entry = _kv_to(entry, self.device)
        if not self._paged:
            self._prefix.insert(tokens, entry)
            return
        nb = -(-tokens.size // self._kv_bs)
        try:
            ids = self._kv_alloc_fill(nb)
        except BlocksExhausted:
            return
        self.pool = _decode.paged_adopt_blocks(self.pool, entry, ids, 0, nb)
        self._prefix.insert(tokens, ids, tokens.size)
        self.kv_manager.free_blocks(ids)     # the store's ref remains

    def cancel(self, uid) -> bool:
        """Drop a request by uid — queued or active (its slot frees
        immediately).  A cancelled request never appears in the
        finished stream; its generated tokens still count in
        ``generated_tokens_total``."""
        for req in self.queue:
            if req.uid == uid:
                self.queue.remove(req)
                self._cancelled += 1
                return True
        for slot, req in enumerate(self._req):
            if req is not None and req.uid == uid:
                self._tokens_total += len(self._generated[slot])
                if self._paged:
                    self._kv_release_slot(slot)
                self._clear_slot(slot)
                self._cancelled += 1
                return True
        return False

    def stats(self) -> dict:
        """Counters for scrapers/logs."""
        out = {
            "slots": self.slots,
            "active": self.active,
            "pending": self.pending,
            "finished_total": self._finished_total,
            "cancelled_total": self._cancelled,
            "generated_tokens_total": self._tokens_total,
            "decode_steps_total": self._steps_total,
            "time_prefill_s": round(self._time_prefill, 4),
            "time_decode_dispatch_s": round(self._time_decode, 4),
            "time_host_s": round(self._time_host, 4),
        }
        if self._prefix is not None:
            out["prefix_hits_total"] = self._prefix.hits
            out["prefix_misses_total"] = self._prefix.misses
            out["prefix_tokens_reused_total"] = self._prefix.tokens_reused
            out["prefix_bytes_reused_total"] = self._prefix.bytes_reused
        if self._exports or self._adoptions:
            out["kv_exports_total"] = self._exports
            out["kv_adoptions_total"] = self._adoptions
        if self._paged:
            view = self.kv_manager.view()
            out["kv_blocks_total"] = view["total_blocks"]
            out["kv_blocks_free"] = view["free_blocks"]
            out["kv_blocks_used"] = view["used_blocks"]
            out["kv_cow_shared_blocks"] = view["cow_shared_blocks"]
            out["kv_block_evictions_total"] = self._prefix.evictions
            out["kv_cow_copies_total"] = (
                self.kv_manager.cow_copies_total)
            out["kv_preemptions_total"] = self._kv_preemptions
            out["kv_alloc_failures_total"] = (
                self.kv_manager.alloc_failures)
            out["kv_spec_trims_total"] = self.kv_manager.spec_trims_total
            if isinstance(self._prefix, TieredKVStore):
                tc = self._prefix.tier_counters()
                out["kv_tier_hits_total"] = tc["hits"]
                out["kv_tier_promotions_total"] = tc["promotions"]
                out["kv_tier_demotions_total"] = tc["demotions"]
                out["kv_tier_corrupt_fallbacks_total"] = (
                    tc["corrupt_fallbacks"])
                out["kv_host_arena_bytes"] = self._prefix.host_arena_bytes()
                out["kv_disk_tier_bytes"] = self._prefix.disk_tier_bytes()
        if self._spec_on:
            out["speculative_windows_total"] = self._spec_windows
            out["speculative_accepted_total"] = self._spec_accepted
            out["speculative_drafts_total"] = self._spec_drafts
            out["spec_accept_rate"] = self._spec_accept_rate()
        if self.adapter_pool is not None:
            pool = self.adapter_pool
            out["adapter_residents"] = len(pool.resident())
            out["adapter_pool_slots"] = pool.n_resident
            out["adapter_hits_total"] = pool.hits_total
            out["adapter_cold_loads_total"] = pool.cold_loads_total
            out["adapter_evictions_total"] = pool.evictions_total
        if self._graphs is not None:
            out["graph_captures_total"] = self._graphs.captures
            out["graph_capture_s"] = round(self._graphs.capture_s, 4)
            out["graph_replays_total"] = self._graphs.replays
        return out

    # -- slot lifecycle --------------------------------------------------

    def _generator(self, slot: int, req: Request
                   ) -> torch.Generator | None:
        """The slot's generator reseeded with the request's seed (None
        for greedy requests): every fill, rerun included, restarts the
        request's stream from its seed."""
        if req.temperature <= 0:
            return None
        return self._slot_gens[slot].manual_seed(int(req.seed))

    def _occupy(self, slot: int, req: Request) -> None:
        self._req[slot] = req
        self._pos[slot] = req.prompt.size
        self._temps[slot] = max(req.temperature, 0.0)

    def _clear_slot(self, slot: int) -> None:
        """Free the slot (finish, cancel, preemption), dropping its
        adapter pin."""
        self._adapter_release(slot)
        self._req[slot] = None
        self._generated[slot] = []
        self._temps[slot] = 0.0

    def _prompt(self, req: Request, start: int = 0,
                stop: int | None = None) -> torch.Tensor:
        return torch.as_tensor(req.prompt[start:stop], dtype=torch.long,
                               device=self.device)

    def _fill_dispatch(self, slot: int, req: Request) -> torch.Tensor:
        """Chunked fill of one request: prefill on a fresh [1, S] cache
        (from the longest remembered prefix when the prefix cache is
        on) in ``prefill_chunk``-token chunks, copy its K/V rows into
        the slot, and return the first token as a device scalar."""
        start = 0
        if self._prefix is not None:
            p, entry = self._prefix.longest_prefix(req.prompt)
            if p > 0:
                # the entry stays intact for later hits: clone it
                one = _decode.copy_cache(entry, p)
                start = p
        if start == 0:
            one = init_cache(self.cfg, 1, self.max_seq,
                             device=self.device, mesh=self.mesh)
        c = self.prefill_chunk or req.prompt.size
        for off in range(start, req.prompt.size, c):
            logits, one = _decode._prefill(
                self.params, self._prompt(req, off, off + c)[None],
                self.cfg, one, off == 0, mesh=self.mesh)
        if self._prefix is not None:
            self._prefix.insert(req.prompt, one)
        if self.draft_params is not None:
            # the draft needs its own K/V of the prompt (prefix entries
            # hold the target's only), in the same chunks
            one_d = init_cache(self.draft_cfg, 1, self.max_seq,
                               device=self.device, mesh=self.mesh)
            for off in range(0, req.prompt.size, c):
                _, one_d = _draft_prefill(
                    self.draft_params, self._prompt(req, off, off + c)[None],
                    self.draft_cfg, one_d, off == 0, mesh=self.mesh)
            self._draft_cache = _adopt_slot(self._draft_cache, one_d, slot)
            if req.temperature > 0:
                self._draft_gens[slot].manual_seed(
                    (int(req.seed) ^ _DRAFT_SEED_SALT) % 2 ** 64)
        gen = self._generator(slot, req)
        first = self._first_token(logits, req, gen)
        self.cache = _adopt_slot(self.cache, one, slot)
        self._occupy(slot, req)
        return first

    def _first_token(self, logits, req: Request, gen) -> torch.Tensor:
        """First token of a per-request fill as a device scalar: argmax
        for greedy requests, a draw from ``gen`` for sampled ones."""
        if gen is None:
            return logits[0, -1].argmax()
        return _sample_one(logits[0, -1], gen, req.temperature,
                           self.top_k, self.top_p)

    def _fill_finalize(self, slot: int, first: int) -> None:
        """Record the resolved first token of a filled slot.  Every fill
        funnels through here, so it is also where the slot's adapter is
        pinned in the pool (the refill's admission gate made that
        acquire infallible) and where the n-gram source snapshots the
        slot's prompt (the lookup matches against the prompt only,
        static for the whole request)."""
        if self.adapter_pool is not None:
            self._adapter_bind(slot)
        self._generated[slot] = [first]
        self._last[slot] = first
        if self._ngram:
            prompt = self._req[slot].prompt
            self._ngram_ctx[slot, :] = 0
            self._ngram_ctx[slot, :prompt.size] = prompt
            self._ngram_len[slot] = prompt.size
            self._ngram_dev = None

    # -- adapter lifecycle (serving_lora/) -------------------------------
    #
    # A slot pins its adapter for its whole decode (acquire at
    # _fill_finalize, release at finish / cancel / preemption), so
    # eviction pressure only ever claims cold adapters.

    def _adapter_bind(self, slot: int) -> None:
        """Pin the slot's adapter and point its slot id at the pinned
        pool slot (the null adapter for a base request).  A cold adapter
        is loaded here, into its pool slot in place."""
        aid = self._req[slot].adapter
        sid = self.adapter_pool.acquire(aid)
        self._adapter[slot] = aid
        if sid != int(self._adapter_slot[slot]):
            self._adapter_slot[slot] = sid
            self._lora_dev = None

    def _adapter_release(self, slot: int) -> None:
        """Drop the slot's pin (the weights stay resident until eviction
        pressure claims them) and point its slot id back at the null
        adapter."""
        if self.adapter_pool is None or self._adapter[slot] is None:
            return
        self.adapter_pool.release(int(self._adapter_slot[slot]))
        self._adapter[slot] = None
        self._adapter_slot[slot] = 0
        self._lora_dev = None

    def _adapter_admit(self, req: Request, pend: set) -> bool:
        """The refill round's admission gate.  Every distinct adapter a
        round pins costs at most one pool slot at finalize time, so a
        request is admitted only while free + evictable slots cover the
        round's distinct adapters: conservative, which makes
        ``_fill_finalize``'s acquire infallible in any order.  False
        keeps the request queued at the head (FIFO kept)."""
        if (self.adapter_pool is None or req.adapter is None
                or req.adapter in pend):
            return True
        if self.adapter_pool.headroom_slots() <= len(pend):
            return False
        pend.add(req.adapter)
        return True

    def _lora_args(self):
        """The decode functions' ``lora`` argument: (per-row pool slot
        ids on the device, the pool's buffers), or None without a pool,
        which leaves the base path and its dispatch counts as they
        were."""
        if self.adapter_pool is None:
            return None
        if self._lora_dev is None:
            self._lora_dev = torch.as_tensor(self._adapter_slot,
                                             device=self.device)
        return (self._lora_dev, self._lora_layers)

    def _finish_slot(self, slot: int, out: list[Finished]) -> None:
        req = self._req[slot]
        gen = self._generated[slot]               # eos token kept
        if len(gen) > 1 and self._prefix is not None and req.adapter is None:
            # multi-turn reuse: remember the finished conversation so a
            # follow-up prompt adopts the whole history.  Rows written
            # so far = prompt + gen[:-1] (the last token was sampled but
            # never fed back), which is exactly _pos[slot].  The
            # fill-time prompt entry is a strict prefix of it and is
            # dropped.  Base requests only: decode-written K/V depends on
            # the adapter through the residual stream, and the store is
            # shared by every adapter (fill-time prompt entries stay:
            # prefill is base-model).
            written = np.concatenate(
                [req.prompt, np.asarray(gen[:-1], np.int32)])
            if len(written) != int(self._pos[slot]):
                raise RuntimeError(
                    f"prefix-capture invariant broken on slot {slot}: "
                    f"{len(written)} written rows vs pos "
                    f"{int(self._pos[slot])}")
            self._prefix.drop(req.prompt)
            if self._paged:
                # free here: the store takes references on the slot's
                # own blocks
                self._prefix.insert(written, self._slot_blocks[slot],
                                    len(written))
            else:
                self._prefix.insert(written, _extract_slot(
                    self.cache, slot, int(self._pos[slot])))
        if self._paged:
            self._kv_release_slot(slot)
        out.append(Finished(
            uid=req.uid,
            tokens=np.concatenate([req.prompt,
                                   np.asarray(gen, np.int32)]),
            n_prompt=req.prompt.size))
        self._finished_total += 1
        self._tokens_total += len(gen)
        self._clear_slot(slot)

    def _done(self, slot: int, pos_offset: int = 0) -> bool:
        """``pos_offset``: tokens appended this step but not yet folded
        into ``_pos`` (the speculative emit loop advances ``_pos`` after
        it), so the capacity clause tests the row's actual position."""
        req = self._req[slot]
        gen = self._generated[slot]
        return (len(gen) >= req.max_new
                or (req.eos_id is not None and gen
                    and gen[-1] == req.eos_id)
                or int(self._pos[slot]) + pos_offset + 1 >= self.max_seq)

    # -- the step loop ---------------------------------------------------

    def step(self) -> list[Finished]:
        """Run ONE batched decode step (with ``chain_steps`` > 1: one
        fused block with the refill overlapped) and refill free slots
        from the queue, returning newly finished requests.  No-op
        (empty list) when idle."""
        t_step = time.perf_counter()
        fill0, dec0 = self._time_prefill, self._time_decode
        try:
            with torch.no_grad():
                return self._step_inner()
        finally:
            self._time_host += ((time.perf_counter() - t_step)
                                - (self._time_prefill - fill0)
                                - (self._time_decode - dec0))

    def _step_inner(self) -> list[Finished]:
        finished: list[Finished] = []
        if self.chain_steps > 1:
            return self._fused_step(finished)
        self._refill(finished)
        active = [s for s in range(self.slots)
                  if self._req[s] is not None]
        if not active:
            return finished
        if self._spec_on:
            return self._spec_step(active, finished)
        if self._paged:
            # block upkeep BEFORE the step: boundary appends and CoW
            # copies; under exhaustion this may preempt slots
            self._kv_prepare_step(active)
            active = [s for s in active if self._req[s] is not None]
            if not active:
                return finished
        t_dec = time.perf_counter()
        tokens = torch.as_tensor(self._last[:, None], dtype=torch.long,
                                 device=self.device)
        pos = torch.as_tensor(self._pos, device=self.device)
        if self._paged:
            if self._table_dev is None:
                self._table_dev = torch.as_tensor(self._table,
                                                  device=self.device)
            logits, self.pool = _decode.paged_decode_step_rows(
                self.params, tokens, self.cfg, self.pool,
                self._table_dev, pos, self._kv_use_kernel,
                self._lora_args(), mesh=self.mesh)
        else:
            logits, self.cache = decode_step_rows(
                self.params, tokens, self.cfg, self.cache, pos,
                self._lora_args(), mesh=self.mesh)
        if self._temps.any():
            nxt_dev = _next_tokens(logits, self._slot_gens, self._temps,
                                   self.top_k, self.top_p)
        else:
            nxt_dev = logits.argmax(dim=-1)
        nxt = nxt_dev.cpu().numpy().astype(np.int32)
        dispatch.record_readback("step_tokens")
        self._time_decode += time.perf_counter() - t_dec
        self._steps_total += 1
        for slot in active:
            self._pos[slot] += 1
            self._generated[slot].append(int(nxt[slot]))
            self._last[slot] = nxt[slot]
            if self._done(slot):
                self._finish_slot(slot, finished)
        return finished

    def _fused_step(self, finished: list[Finished]) -> list[Finished]:
        """One fused generation block with the refill OVERLAPPED: the
        block for the slots active now is launched first, then the host
        refills the slots the previous block freed while the device
        runs it; the fills go on the same stream, after the block, so
        they cannot race its cache writes.  Newly filled slots join the
        next block; each row's continuation is independent of the
        others, so the tokens equal the step-at-a-time engine's under
        any refill timing.

        Each row's stop state goes down with the block: ``budget`` (the
        tokens it may still emit before ``max_new`` or the cache's
        capacity line, exactly ``_done``'s bounds, less the window's
        scratch rows when speculating; 0 for a free slot) and ``eos``;
        rows freeze on the device when they finish, and the host reads
        back ONE packed array of tokens and per-row counts after the
        rows-finished count.

        A speculative engine's block runs up to ``chain_steps`` windows
        a row (draft, one target window forward, accept, all on the
        device), up to ``chain_steps * (draft_len + 1)`` tokens a row,
        rows at different accept depths sharing the block; the packed
        tail adds each row's accepted drafts and windows run, so the
        accept rate costs no extra readback."""
        active = [s for s in range(self.slots)
                  if self._req[s] is not None]
        if not active:
            self._refill(finished)
            return finished
        k = self.chain_steps
        kd = self.draft_len if self._spec_on else 0
        width = k * (kd + 1)
        t_dec = time.perf_counter()
        budget = np.zeros(self.slots, np.int32)
        eos = np.full(self.slots, -1, np.int32)
        for slot in active:
            req = self._req[slot]
            budget[slot] = min(
                req.max_new - len(self._generated[slot]),
                self.max_seq - 1 - kd - int(self._pos[slot]))
            if req.eos_id is not None:
                eos[slot] = req.eos_id
        ctx = ((self._ngram_ctx, self._ngram_len) if self._ngram
               else (None, None))
        if self._graphs is not None:
            lora = (None if self.adapter_pool is None else
                    (self._adapter_slot, self.adapter_pool.buffers))
            self._graphs.launch(self.params, self.cache, self._last,
                                self._pos, self._temps, budget, eos, *ctx,
                                lora)
        else:
            # the step-by-step block: the CPU's, and the card's under a
            # mesh (its inputs uploaded by _BlockState.load)
            args = (self.params, torch.as_tensor(self._last), self.cfg,
                    self.cache, torch.as_tensor(self._pos), k,
                    self._slot_gens, torch.as_tensor(self._temps),
                    torch.as_tensor(budget), torch.as_tensor(eos))
            if self._spec_on:
                ctx = [None if c is None else
                       torch.as_tensor(c, device=self.device) for c in ctx]
                packed, rows_done, self.cache = \
                    _decode.decode_spec_fused_rows(
                        *args, *ctx, self.draft_params, self.draft_cfg,
                        self._draft_cache, self._draft_gens, kd,
                        self.top_k, self.top_p, self._lora_args(),
                        mesh=self.mesh)
            else:
                packed, rows_done, self.cache = _decode.decode_fused_rows(
                    *args, self.top_k, self.top_p, self._lora_args(),
                    mesh=self.mesh)
        self._time_decode += time.perf_counter() - t_dec
        self._refill(finished)          # overlaps the running block
        t_wait = time.perf_counter()
        if self._graphs is not None:
            arr, _ = self._graphs.collect()
        else:
            int(rows_done)
            arr = packed.cpu().numpy()
        dispatch.record_readback("fused_spec_block" if self._spec_on
                                 else "fused_block")
        self._time_decode += time.perf_counter() - t_wait
        if self._spec_on:
            windows = [int(arr[s, width + 2]) for s in active]
            self._steps_total += max(windows)
            self._spec_windows += max(windows)
            self._spec_drafts += sum(windows) * kd
            self._spec_accepted += sum(int(arr[s, width + 1])
                                       for s in active)
        else:
            self._steps_total += int(max(arr[s, width] for s in active))
        for slot in active:
            for j in range(int(arr[slot, width])):
                self._pos[slot] += 1
                self._generated[slot].append(int(arr[slot, j]))
                self._last[slot] = arr[slot, j]
            if self._done(slot):
                self._finish_slot(slot, finished)
        return finished

    def _ngram_context(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The n-gram contexts and lengths on the device, the contexts
        uploaded again only after a fill changed them."""
        if self._ngram_dev is None:
            self._ngram_dev = torch.as_tensor(self._ngram_ctx,
                                              device=self.device)
        return self._ngram_dev, torch.as_tensor(self._ngram_len,
                                                device=self.device)

    def _spec_step(self, active: list[int],
                   finished: list[Finished]) -> list[Finished]:
        """One speculative window: the draft proposes ``draft_len``
        tokens a slot, the target scores the whole window in one
        ``decode_window_rows`` pass, and each row emits its accepted
        prefix plus a correction / bonus token.

        Greedy-only batches take the lean path: the target's argmax and
        the proposals come back in one packed readback and the prefix
        match runs on the host.  With any sampled row, the draft samples
        (``draft_sample_rows``; the n-gram's one-hot q) and
        ``spec_accept_rows`` accepts every row on the device, one packed
        readback of the emitted tokens and counts.

        Inactive rows ride along at stale positions (in bounds: the
        intake margin); rejected rows stay in the caches, masked by
        position, and the next window rewrites them.  On the paged
        layout, writable blocks covering the whole window are reserved
        first (``_kv_prepare_step(span=draft_len + 1)``) and blocks past
        the accepted prefix are trimmed after (``_kv_spec_trim``)."""
        k = self.draft_len
        if self._paged:
            self._kv_prepare_step(active, span=k + 1)
            active = [s for s in active if self._req[s] is not None]
            if not active:
                return finished
        t_dec = time.perf_counter()
        last = torch.as_tensor(self._last, dtype=torch.long,
                               device=self.device)
        pos = torch.as_tensor(self._pos, device=self.device)
        sampled_mode = bool(self._temps.any())
        temps = torch.as_tensor(self._temps, device=self.device)
        if self._ngram:
            proposals, q_probs = draft_ngram_rows(
                *self._ngram_context(), last, k, self.cfg.vocab,
                sampled_mode)
        elif sampled_mode:
            proposals, q_probs, self._draft_cache = draft_sample_rows(
                self.draft_params, last, self.draft_cfg, self._draft_cache,
                pos, k, self._draft_gens, temps, self.top_k, self.top_p,
                mesh=self.mesh)
        else:
            proposals, self._draft_cache = draft_propose_rows(
                self.draft_params, last, self.draft_cfg, self._draft_cache,
                pos, k, mesh=self.mesh)
        window = torch.cat([last[:, None], proposals], dim=1)
        if self._paged:
            if self._table_dev is None:
                self._table_dev = torch.as_tensor(self._table,
                                                  device=self.device)
            logits, self.pool = _decode.paged_window_rows(
                self.params, window, self.cfg, self.pool, self._table_dev,
                pos, self._lora_args(), mesh=self.mesh)
        else:
            logits, self.cache = decode_window_rows(
                self.params, window, self.cfg, self.cache, pos,
                self._lora_args(), mesh=self.mesh)
        if sampled_mode:
            emit, a = spec_accept_rows(logits, proposals, q_probs,
                                       self._slot_gens, temps, self.top_k,
                                       self.top_p)
            packed = torch.cat([emit, a[:, None]], dim=1).cpu().numpy()
            emit_all, a_all = packed[:, :-1], packed[:, -1]
        else:
            packed = torch.cat([logits.argmax(dim=-1), proposals],
                               dim=1).cpu().numpy()
            greedy, props = packed[:, :k + 1], packed[:, k + 1:]
        dispatch.record_readback("spec_window")
        self._time_decode += time.perf_counter() - t_dec
        self._steps_total += 1
        self._spec_windows += 1
        self._spec_drafts += k * len(active)
        for slot in active:
            if sampled_mode:
                a = int(a_all[slot])
                emit = list(emit_all[slot, :a + 1])
            else:
                a = 0
                while a < k and props[slot, a] == greedy[slot, a]:
                    a += 1
                emit = list(props[slot, :a]) + [greedy[slot, a]]
            appended = 0
            for tok in emit:
                self._generated[slot].append(int(tok))
                self._last[slot] = tok
                appended += 1
                if self._done(slot, pos_offset=appended):
                    break
            # only drafts actually emitted count (an EOS or max_new cut
            # discards the rest)
            self._spec_accepted += min(appended, a)
            # the window wrote last and every accepted draft; the final
            # appended token's own row stays unwritten either way, the
            # plain step's gen[-1]-unwritten invariant
            self._pos[slot] += appended
            if self._paged:
                self._kv_spec_trim(slot)
            if self._done(slot):
                self._finish_slot(slot, finished)
        return finished

    def _refill(self, finished: list[Finished]) -> None:
        """Fill free slots from the queue in batched rounds: every free
        slot's prefill is dispatched first, then the first tokens are
        resolved in ONE readback.  A refilled request whose first token
        already finishes it must complete here, so its freed slot feeds
        the next round."""
        if self._paged:
            return self._kv_refill(finished)
        for slot in range(self.slots):
            if self._req[slot] is not None and self._done(slot):
                self._finish_slot(slot, finished)
        while self.queue and any(r is None for r in self._req):
            t_fill = time.perf_counter()
            batch = []
            pend: set = set()      # adapters this round will pin
            for slot in range(self.slots):
                if self._req[slot] is None and self.queue:
                    if not self._adapter_admit(self.queue[0], pend):
                        break
                    batch.append((slot, self.queue.popleft()))
            if not batch:
                # the head's adapter needs a pool slot and none is
                # claimable: requests stay queued until a pin drops
                self._time_prefill += time.perf_counter() - t_fill
                return
            if self.prefill_chunk is None and self.draft_params is None:
                firsts = self._fill_fused_round(batch)
            else:
                firsts = torch.stack(
                    [self._fill_dispatch(s, r) for s, r in batch]
                ).cpu().numpy()
                dispatch.record_readback("fill_round")
            self._time_prefill += time.perf_counter() - t_fill
            for (slot, _), first in zip(batch, firsts):
                self._fill_finalize(slot, int(first))
                if self._done(slot):
                    self._finish_slot(slot, finished)

    def _fill_fused_round(self, batch: list) -> np.ndarray:
        """One refill round, ONE readback: prefix-cache hits ride
        ``suffix_fill_adopt`` (one call each) and fresh fills are
        grouped by prompt length through ``prefill_adopt_rows`` (one
        call per group).  ``batch`` is narrowed in place to the
        requests kept this round."""
        by_slot: dict[int, torch.Tensor] = {}
        fresh = batch
        if self._prefix is not None:
            fresh, kept, deferred = [], [], []
            live: list[np.ndarray] = []   # prompts filling THIS round
            for slot, req in batch:
                cap = req.prompt.size - 1
                best_live = max((min(_overlap(req.prompt, pr), cap)
                                 for pr in live), default=0)
                if best_live > self._prefix.peek(req.prompt):
                    # a longer match is filling right now (the shared
                    # system-prompt pattern): defer one round and adopt
                    # that fill instead of recomputing it; the first of
                    # an overlapping set is never deferred
                    deferred.append(req)
                    continue
                live.append(req.prompt)
                kept.append((slot, req))
                p, entry = self._prefix.longest_prefix(req.prompt)
                if p > 0:
                    by_slot[slot] = self._fill_hit(slot, req, p, entry)
                else:
                    fresh.append((slot, req))
            self.queue.extendleft(reversed(deferred))
            batch[:] = kept               # the caller zips over batch
        if fresh:
            self._fill_fresh_groups(fresh, by_slot)
            if self._prefix is not None:
                # remember each fresh prompt's K/V for later hits: the
                # freshly adopted slot rows ARE that K/V
                for slot, req in fresh:
                    self._prefix.insert(req.prompt, _extract_slot(
                        self.cache, slot, int(req.prompt.size)))
        firsts = torch.stack([by_slot[s] for s, _ in batch])
        out = firsts.cpu().numpy()
        dispatch.record_readback("fill_round")
        return out

    def _fill_hit(self, slot: int, req: Request, p: int,
                  entry: KVCache) -> torch.Tensor:
        """Prefix-HIT fill: the remembered ``p`` rows plus a suffix
        prefill, adopted into the slot, first token drawn — one call
        (``suffix_fill_adopt``)."""
        one = dataclasses.replace(entry, pos=p)
        gen = self._generator(slot, req)
        first, self.cache, filled = _decode.suffix_fill_adopt(
            self.params, one, self._prompt(req, p), self.cfg,
            self.cache, slot, gen, req.temperature, self.top_k,
            self.top_p, mesh=self.mesh)
        self._prefix.insert(req.prompt, filled)
        self._occupy(slot, req)
        return first

    def _fill_fresh_groups(self, batch: list, by_slot: dict) -> None:
        """Fresh fills grouped by prompt length through
        ``prefill_adopt_rows``: one call per group, padded to ``slots``
        rows by repeating its first prompt (the JAX engine's padding),
        so a request's fill does not depend on its group's size."""
        groups: dict[int, list] = {}
        for slot, req in batch:
            groups.setdefault(req.prompt.size, []).append((slot, req))
        for grp in groups.values():
            gens = [self._generator(s, r) for s, r in grp]
            pad = [grp[0][1].prompt] * (self.slots - len(grp))
            prompts = torch.as_tensor(
                np.stack([r.prompt for _, r in grp] + pad),
                dtype=torch.long, device=self.device)
            first, self.cache = _decode.prefill_adopt_rows(
                self.params, prompts, self.cfg, self.cache,
                [s for s, _ in grp], gens,
                [r.temperature for _, r in grp], self.top_k, self.top_p,
                mesh=self.mesh)
            for i, (slot, req) in enumerate(grp):
                self._occupy(slot, req)
                by_slot[slot] = first[i]

    # -- paged KV (serving_kv/): fills, block upkeep, preemption ---------
    #
    # The paged engine keeps the contiguous engine's scheduling (batched
    # refill rounds, same-round shared-prefix deferral, per-request
    # sampling) and changes only where K/V rows live: fills run the same
    # dense [1, S] prefill on a transient cache and copy the rows into
    # pool blocks; decode reads through per-slot block tables.  Token
    # streams are schedule-independent, so preempt-and-rerun under
    # memory pressure never changes tokens.

    def _kv_entry_dense(self, entry, pos: int) -> KVCache:
        """Gather a store entry's blocks into a fresh dense
        [1, max_seq] cache with ``pos`` valid rows."""
        ids = np.full(self._kv_tw, NULL_BLOCK, np.int32)
        ids[:len(entry.block_ids)] = entry.block_ids
        return _decode.paged_gather_entry(self.pool, ids, pos)

    def _kv_alloc_fill(self, n: int) -> list[int]:
        """Fill-path allocation: free supply first, then cold-entry
        eviction.  Never preempts; BlocksExhausted propagates to the
        caller's requeue."""
        try:
            return self.kv_manager.alloc(n)
        except BlocksExhausted:
            self._prefix.evict_until(n)
            return self.kv_manager.alloc(n)

    # -- the tiered store's device halves (serving_kv/tiers.py) ----------
    #
    # The store decides which entry demotes and when a hit promotes;
    # these two callbacks move the bytes, because the engine owns the
    # pool.

    def _tier_gather(self, entry) -> tuple[list, list]:
        """Demotion gather: the entry's valid blocks as per-layer CPU
        tensors [n_blocks, block_size, H_kv, D], read through the
        fills' own gather (``paged_gather``).  Safe on shared blocks:
        their content is immutable while the store holds references (a
        writer copies first)."""
        nb = len(entry.block_ids)
        bs = self._kv_bs
        one = self._kv_entry_dense(entry, entry.length)

        def host(lst):
            return [a[0, :nb * bs].reshape(nb, bs, *a.shape[2:]).to(
                "cpu", copy=True) for a in lst]

        return host(one.k), host(one.v)

    def _tier_adopt(self, slab_k: list, slab_v: list) -> list[int]:
        """Promotion adopt: copy a host slab into freshly allocated
        blocks (fill-path allocation: eviction yes, preemption never;
        ``BlocksExhausted`` tells the store the promotion lost the race
        to memory pressure).  Returns the block ids, whose allocation
        references the caller owns; they are freed again if the copy
        raises."""
        ids = self._kv_alloc_fill(slab_k[0].shape[0])
        try:
            self.pool = _decode.paged_adopt_slab(self.pool, slab_k, slab_v,
                                                 ids)
        except Exception:
            self.kv_manager.free_blocks(ids)
            raise
        return ids

    def _kv_alloc_decode(self, slot: int, n: int) -> list[int]:
        """Decode-path allocation with the full escalation: free
        supply -> cold-entry eviction -> preempt the cheapest OTHER
        slot (fewest generated tokens, ties to the highest slot index).
        Raises only when nothing is left to reclaim."""
        while True:
            try:
                return self.kv_manager.alloc(n)
            except BlocksExhausted:
                pass
            if self._prefix.evict_until(n):
                continue
            victims = [s for s in range(self.slots)
                       if s != slot and self._req[s] is not None]
            if not victims:
                raise BlocksExhausted(
                    f"{n} block(s) needed and nothing left to "
                    f"reclaim")
            victim = min(victims,
                         key=lambda s: (len(self._generated[s]), -s))
            self._kv_preempt(victim)

    def _kv_preempt(self, slot: int) -> None:
        """Evict a running request: free its blocks and requeue the
        ORIGINAL request at the queue front.  The rerun prefills the
        same prompt from the same seed, so its tokens are identical."""
        self.queue.appendleft(self._req[slot])
        self._kv_release_slot(slot)
        self._clear_slot(slot)
        self._kv_preemptions += 1

    def _kv_release_slot(self, slot: int) -> None:
        """Drop the slot's block references and point its table row
        back at the null block."""
        if self._slot_blocks[slot]:
            self.kv_manager.free_blocks(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self._table[slot, :] = NULL_BLOCK
        self._table_dev = None

    def _kv_prepare_step(self, active: list, span: int = 1) -> None:
        """Host-side block upkeep before a paged step: append a block
        when a row crosses a block boundary; copy-on-write the write
        block when it is shared.  ``span`` widens the write window: the
        speculative path reserves ``draft_len + 1`` rows [pos,
        pos + draft_len] so the whole window lands in writable blocks
        (the scratch blocks are trimmed after the accept,
        ``_kv_spec_trim``).  Under exhaustion: evict cold -> preempt the
        cheapest other slot -> self-preempt."""
        bs = self._kv_bs
        for slot in active:
            if self._req[slot] is None:
                continue              # preempted earlier in this pass
            pos = int(self._pos[slot])
            blocks = self._slot_blocks[slot]
            try:
                for bi in range(pos // bs, (pos + span - 1) // bs + 1):
                    if bi == len(blocks):
                        nid = self._kv_alloc_decode(slot, 1)[0]
                        blocks.append(nid)
                        self._table[slot, bi] = nid
                        self._table_dev = None
                    elif not self.kv_manager.writable(blocks[bi]):
                        nid = self._kv_alloc_decode(slot, 1)[0]
                        self.pool = _decode.paged_copy_block(
                            self.pool, blocks[bi], nid)
                        self.kv_manager.free_blocks([blocks[bi]])
                        self.kv_manager.note_cow_copy()
                        blocks[bi] = nid
                        self._table[slot, bi] = nid
                        self._table_dev = None
            except BlocksExhausted:
                self._kv_preempt(slot)

    def _kv_spec_trim(self, slot: int) -> None:
        """Rejected-draft rollback, the paged way: keep the blocks
        covering the accepted prefix [0, _pos) and release every
        window-scratch block past them (``KVBlockManager.trim_tail``), a
        table edit and a refcount release; no pool byte moves.  The next
        window reserves and rewrites the same offsets."""
        keep = -(-int(self._pos[slot]) // self._kv_bs)
        if self.kv_manager.trim_tail(self._slot_blocks[slot], keep):
            self._table[slot, keep:] = NULL_BLOCK
            self._table_dev = None

    def _kv_can_admit(self, req: Request) -> bool:
        """Admission gate for the paged refill: can the manager cover
        this fill's fresh blocks (plus one block of first-append
        headroom), counting cold store entries as reclaimable?"""
        bs = self._kv_bs
        p = self._prefix.peek(req.prompt)
        need = -(-req.prompt.size // bs) - p // bs + 1
        return (self.kv_manager.free
                + self._prefix.evictable_count()) >= need

    def _kv_refill(self, finished: list) -> None:
        """Paged refill: the same batched rounds and shared-prefix
        deferral, behind the admission gate.  A fill that still hits
        BlocksExhausted puts its request (and the rest of the round)
        back at the queue front."""
        for slot in range(self.slots):
            if self._req[slot] is not None and self._done(slot):
                self._finish_slot(slot, finished)
        while self.queue and any(r is None for r in self._req):
            t_fill = time.perf_counter()
            batch = []
            pend: set = set()      # adapters this round will pin
            for slot in range(self.slots):
                if self._req[slot] is None and self.queue:
                    if not self._kv_can_admit(self.queue[0]):
                        break
                    if not self._adapter_admit(self.queue[0], pend):
                        break
                    batch.append((slot, self.queue.popleft()))
            if not batch:
                self._time_prefill += time.perf_counter() - t_fill
                return
            kept, deferred = [], []
            live: list[np.ndarray] = []   # prompts filling THIS round
            for slot, req in batch:
                cap = req.prompt.size - 1
                best_live = max((min(_overlap(req.prompt, pr), cap)
                                 for pr in live), default=0)
                if best_live > self._prefix.peek(req.prompt):
                    # share this round's longer fill next round
                    deferred.append(req)
                    continue
                live.append(req.prompt)
                kept.append((slot, req))
            self.queue.extendleft(reversed(deferred))
            batch = kept
            by_slot, short = {}, False
            for i, (slot, req) in enumerate(batch):
                try:
                    by_slot[slot] = self._kv_fill_one(slot, req)
                except BlocksExhausted:
                    for _, r in reversed(batch[i:]):
                        self.queue.appendleft(r)
                    batch = batch[:i]
                    short = True
                    break
            firsts = (torch.stack([by_slot[s] for s, _ in batch])
                      .cpu().numpy() if batch else [])
            if batch:
                dispatch.record_readback("fill_round")
            self._time_prefill += time.perf_counter() - t_fill
            for (slot, _), first in zip(batch, firsts):
                self._fill_finalize(slot, int(first))
                if self._done(slot):
                    self._finish_slot(slot, finished)
            if short:
                return

    def _kv_fill_one(self, slot: int, req: Request) -> torch.Tensor:
        """Paged fill: the longest remembered prefix is shared
        (refcount bumps on its fully covered blocks), the suffix rides
        the same dense prefill the contiguous engine runs, and fresh
        tail blocks are copied into the pool.  Returns the first token
        as a device scalar."""
        L = req.prompt.size
        bs = self._kv_bs
        p, entry = self._prefix.longest_prefix(req.prompt)
        full = p // bs
        nb = -(-L // bs)
        # hold references on every entry block the gather reads (the
        # partial boundary block included) so eviction inside the
        # alloc fallback cannot free them mid-fill
        guard = list(entry.block_ids[:-(-p // bs)]) if p else []
        if guard:
            self.kv_manager.share(guard)
        try:
            fresh = (self._kv_alloc_fill(nb - full)
                     if nb > full else [])
        except BlocksExhausted:
            if guard:
                self.kv_manager.free_blocks(guard)
            raise
        if p > 0:
            key = req.prompt[:p].tobytes()
            memo = self._kv_dense_memo
            if memo is not None and memo[0] == key:
                # the fill writes into its dense cache: work on a copy
                one = _decode.copy_cache(memo[1], p)
            else:
                one = self._kv_entry_dense(entry, p)
                self._kv_dense_memo = (key, _decode.copy_cache(one, p))
        else:
            one = init_cache(self.cfg, 1, self.max_seq,
                             device=self.device, mesh=self.mesh)
        fill = _prefill_suffix if p > 0 else _decode._prefill
        c = self.prefill_chunk or L
        for off in range(p, L, c):
            logits, one = fill(self.params,
                               self._prompt(req, off, off + c)[None],
                               self.cfg, one, off == 0, mesh=self.mesh)
        if fresh:
            self.pool = _decode.paged_adopt_blocks(
                self.pool, one, fresh, full, nb - full)
        # the fully covered guard refs BECOME the slot's references; a
        # partial boundary block was recomputed into a fresh block, so
        # its guard ref is dropped
        if p % bs:
            self.kv_manager.free_blocks([guard[-1]])
        blocks = guard[:full] + fresh
        self._slot_blocks[slot] = blocks
        self._table[slot, :] = NULL_BLOCK
        self._table[slot, :nb] = blocks
        self._table_dev = None
        # fill-time memo: the slot's OWN blocks, shared (the slot's
        # first write into a shared partial block triggers CoW)
        self._prefix.insert(req.prompt, blocks, L)
        gen = self._generator(slot, req)
        first = self._first_token(logits, req, gen)
        self._occupy(slot, req)
        return first

    def _kv_adopt_into(self, slot: int, kv, req: Request) -> None:
        """Land an adopted block's K/V (a slab, or a dense [1, S] cache
        from a contiguous exporter) in fresh pool blocks for ``slot`` and
        insert the prompt into the prefix store: the prefix arrives
        already shared (slot and store refcount the same blocks)."""
        L = req.prompt.size
        nb = -(-L // self._kv_bs)
        ids = self._kv_alloc_fill(nb)
        if isinstance(kv, PagedKVSlab):
            self.pool = _decode.paged_adopt_slab(self.pool, kv.k, kv.v, ids)
        else:
            self.pool = _decode.paged_adopt_blocks(self.pool, kv, ids, 0, nb)
        self._slot_blocks[slot] = list(ids)
        self._table[slot, :] = NULL_BLOCK
        self._table[slot, :nb] = ids
        self._table_dev = None
        self._prefix.insert(req.prompt, ids, L)

    def _kv_prefill_export(self, req: Request) -> KVBlock:
        """Paged export: the same fill on a transient dense [1, S] cache,
        shipped as a :class:`PagedKVSlab` of ceil(L/bs) blocks.  The
        prompt is also remembered locally in pool blocks (cold,
        evictable) when blocks can be had, so a later export of the
        same prefix pays only its suffix."""
        t0 = time.perf_counter()
        p, hit = self._prefix.longest_prefix(req.prompt)
        if p > 0:
            one = self._kv_entry_dense(hit, p)
        else:
            one = init_cache(self.cfg, 1, self.max_seq, device=self.device,
                             mesh=self.mesh)
        logits, one = self._export_fill(req, one, p)
        L = req.prompt.size
        nb = -(-L // self._kv_bs)
        try:
            ids = self._kv_alloc_fill(nb)
        except BlocksExhausted:
            ids = None            # memory pressure: skip the local entry
        if ids is not None:
            self.pool = _decode.paged_adopt_blocks(self.pool, one, ids, 0,
                                                   nb)
            self._prefix.insert(req.prompt, ids, L)
            self.kv_manager.free_blocks(ids)  # the store's ref remains
        slab_k, slab_v = _decode.paged_slab_from_dense(one, nb, self._kv_bs)
        kv = PagedKVSlab(k=slab_k, v=slab_v, pos=L, block_size=self._kv_bs)
        return self._export_block(req, kv, logits, p, t0)

    def run(self, max_steps: int = 10_000) -> list[Finished]:
        """Drain queue + slots; returns every finished request."""
        out: list[Finished] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.queue and self.active == 0:
                return out
        raise RuntimeError(f"not drained after {max_steps} steps")

    def stream(self, max_steps: int = 10_000):
        """Drain like :meth:`run` but yield events incrementally:
        ``("token", uid, token_id)`` for every newly generated token and
        ``("finished", uid, tokens)`` when a request completes.
        Cancelled requests simply stop producing events."""
        yielded: dict[Any, int] = {}
        for _ in range(max_steps):
            # prune counters whose request left without finishing
            # (cancel): a RESUBMITTED uid must restart at token 0
            live = {r.uid for r in self._req if r is not None}
            yielded = {u: n for u, n in yielded.items() if u in live}
            finished = self.step()
            for slot in range(self.slots):
                req = self._req[slot]
                if req is None:
                    continue
                gen = self._generated[slot]
                for tok in gen[yielded.get(req.uid, 0):]:
                    yield ("token", req.uid, int(tok))
                yielded[req.uid] = len(gen)
            for f in finished:
                gen = f.tokens[f.n_prompt:]
                for tok in gen[yielded.pop(f.uid, 0):]:
                    yield ("token", f.uid, int(tok))
                yield ("finished", f.uid, f.tokens)
            if not self.queue and self.active == 0:
                return
        raise RuntimeError(f"not drained after {max_steps} steps")


__all__ = ["Finished", "KVBlock", "PagedKVSlab", "PrefixCache", "Request",
           "ServingEngine"]
