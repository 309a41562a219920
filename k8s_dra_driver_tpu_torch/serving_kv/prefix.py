"""Block-granular prefix store: CoW sharing instead of copies.

The port's own copy of ``k8s_dra_driver_tpu/serving_kv/prefix.py``
(numpy-only there too); only ``kv_bytes_per_token`` differs, reading
torch tensors' byte sizes.  ``tiers.py`` subclasses the store so that
eviction demotes to host memory and disk instead of dropping.

The contiguous engine's ``PrefixCache`` (models/serving.py) retains a
full ``[1, max_seq]`` cache row per remembered prefix (~one slot of
HBM each) and adoption copies rows into the slot.  Here an entry is
just ``(token key, length, block ids)`` — inserting a prefix is a
refcount bump on the slot's own blocks (zero bytes moved), a hit
shares the fully-covered blocks with the new request (refcount bump
again), and only the boundary block of a mid-block match is ever
copied.  Physical blocks stay shared until the first write
(copy-on-write, enforced by the engine through
``KVBlockManager.writable``).

Adoption is therefore exactly the chunked-prefill-with-memoized-
first-chunk argument the dense store makes — the shared blocks hold
bitwise the same rows a fresh prefill would write — so cached and
uncached paged engines generate identical tokens (pinned in
tests/test_torch_serving.py).

Entries whose blocks are referenced ONLY here (refcount 1 — no
active request shares them) are the "cold" supply the engine's
watermark eviction reclaims under pressure (``evict_until``); an
entry still shared with a live slot drops its reference but returns
no memory until the slot finishes.

Both stores, this one and the contiguous ``PrefixCache``, fire the
listeners of :class:`PrefixListeners` (``listeners`` for a prefix
index, ``stats_listeners`` for metrics).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .manager import KVBlockManager


def kv_bytes_per_token(tensors, n_tokens: int) -> int:
    """Per-token KV byte cost measured from REAL tensors — the one
    shared measurement ``bytes_reused`` accounting (dense and paged
    stores) uses.  The caller passes every tensor an entry actually
    holds; ``numel * element_size`` reports what the dtype really
    costs."""
    n = max(int(n_tokens), 1)
    return sum(t.numel() * t.element_size() for t in tensors) // n


@dataclasses.dataclass
class PagedEntry:
    """One remembered prefix: ``length`` valid token rows spread over
    ``block_ids`` (ceil(length / block_size) refcounted blocks, in
    table order)."""

    length: int
    block_ids: tuple[int, ...]


class PrefixListeners:
    """The two listener lists every prefix store fires, where the
    reference fires them: ``listeners`` (``listener(event, key)``, event
    in {"insert", "evict", "drop"} and the tiers' {"demote",
    "demote_disk", "promote"}) — the fleet prefix index's mirror hook —
    and ``stats_listeners`` (``listener(event, tokens, nbytes)``, event
    in {"hit", "miss"}) — the gateway's O(events) prefix accounting.  A
    raising listener is isolated: observability never breaks a fill."""

    def __init__(self) -> None:
        self.listeners: list = []
        self.stats_listeners: list = []

    def _notify(self, event: str, key: tuple) -> None:
        for cb in self.listeners:
            try:
                cb(event, key)
            except Exception:
                pass

    def _notify_stats(self, event: str, tokens: int,
                      nbytes: int) -> None:
        for cb in self.stats_listeners:
            try:
                cb(event, tokens, nbytes)
            except Exception:
                pass


class PagedPrefixStore(PrefixListeners):
    """LRU store of prompt prefixes as shared block-id tuples."""

    def __init__(self, entries: int, manager: KVBlockManager):
        if entries < 1:
            raise ValueError("prefix store needs >= 1 entry")
        super().__init__()
        self.entries = entries
        self._mgr = manager
        # dict insertion order IS the LRU order (oldest first)
        self._store: dict[tuple, PagedEntry] = {}
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.bytes_reused = 0
        self.bytes_per_token = 0
        #: capacity-LRU + pressure evictions (the metrics counter)
        self.evictions = 0
        #: bytes those evictions covered (``entry_nbytes`` per entry,
        #: the same measurement ``bytes_reused`` uses)
        self.bytes_evicted = 0

    def __len__(self) -> int:
        return len(self._store)

    def _touch(self, key: tuple) -> None:
        self._store[key] = self._store.pop(key)

    def _best_match(self, prompt: np.ndarray) -> tuple[int, tuple]:
        """(p, key) of the longest common prefix over all entries,
        capped at len(prompt)-1 so the last prompt token is always
        re-prefilled (its logits seed generation) — the exact
        ``PrefixCache._best_match`` rule."""
        toks = prompt.tolist()
        cap = len(toks) - 1
        best_p, best_key = 0, None
        for key, entry in self._store.items():
            p = 0
            for a, b in zip(key[:entry.length], toks[:cap]):
                if a != b:
                    break
                p += 1
            if p > best_p:
                best_p, best_key = p, key
        return best_p, best_key

    def peek(self, prompt: np.ndarray) -> int:
        """Longest match WITHOUT hit accounting or an LRU touch
        (scheduling probe — same contract as ``PrefixCache.peek``)."""
        return self._best_match(prompt)[0]

    def longest_prefix(self, prompt: np.ndarray
                       ) -> tuple[int, PagedEntry | None]:
        """(p, entry) for the longest remembered prefix; counts the
        hit/miss and refreshes the LRU position."""
        best_p, best_key = self._best_match(prompt)
        if best_key is None:
            self.misses += 1
            self._notify_stats("miss", 0, 0)
            return 0, None
        self.hits += 1
        self.tokens_reused += best_p
        self.bytes_reused += best_p * self.bytes_per_token
        self._notify_stats("hit", best_p,
                           best_p * self.bytes_per_token)
        self._touch(best_key)
        return best_p, self._store[best_key]

    def entry(self, tokens: np.ndarray) -> PagedEntry | None:
        """The entry for EXACTLY ``tokens`` (or None) — the
        fleet-index fetch path.  LRU touch, no hit accounting (reuse
        is counted where tokens are adopted, not stored)."""
        key = tuple(np.asarray(tokens).tolist())
        if key not in self._store:
            return None
        self._touch(key)
        return self._store[key]

    def insert(self, tokens: np.ndarray, block_ids, length: int
               ) -> None:
        """Remember ``tokens`` (length == len(tokens) == valid rows)
        as shared blocks: ONE reference per block is taken here
        (``manager.share``), released on evict/drop.  Zero copies —
        this is finish-time capture for free, the CoW payoff."""
        key = tuple(np.asarray(tokens).tolist())
        if length != len(key):
            raise ValueError(
                f"entry length {length} != token count {len(key)}")
        need = -(-length // self._mgr.block_size)
        if len(block_ids) != need:
            raise ValueError(
                f"{length} rows need {need} blocks, got "
                f"{len(block_ids)}")
        ids = tuple(int(b) for b in block_ids)
        self._mgr.share(ids)
        old = self._store.pop(key, None)      # re-insert = most recent
        if old is not None:
            self._mgr.free_blocks(old.block_ids)
        self._store[key] = PagedEntry(length=length, block_ids=ids)
        self._notify("insert", key)
        while len(self._store) > self.entries:
            self._evict_oldest()

    def entry_nbytes(self, entry: PagedEntry) -> int:
        """Bytes of K/V an entry's valid rows cover — ``length`` times
        the measured per-token cost (:func:`kv_bytes_per_token`), so
        hit-reuse, eviction and demotion accounting share one number."""
        return int(entry.length) * int(self.bytes_per_token)

    def _evict_oldest(self) -> tuple[tuple, PagedEntry, int]:
        """Drop the LRU-oldest entry; returns ``(key, entry, nbytes)``
        so pressure paths (and the tiered store's demotion override)
        see per-eviction byte sizes, not just a count."""
        key = next(iter(self._store))
        entry = self._store.pop(key)
        self._mgr.free_blocks(entry.block_ids)
        nbytes = self.entry_nbytes(entry)
        self.evictions += 1
        self.bytes_evicted += nbytes
        self._notify("evict", key)
        return key, entry, nbytes

    def drop(self, tokens: np.ndarray) -> None:
        """Forget an entry (no-op if absent), releasing its block
        references — used when a finish capture strictly dominates
        its fill-time prompt entry."""
        key = tuple(np.asarray(tokens).tolist())
        entry = self._store.pop(key, None)
        if entry is not None:
            self._mgr.free_blocks(entry.block_ids)
            self._notify("drop", key)

    def evictable_count(self) -> int:
        """Blocks that would return to the free pool if EVERY entry
        were evicted — blocks whose only references are store-held
        (the cold supply).  The engine's admission gate counts this
        as reclaimable headroom; a block shared with a live slot
        contributes nothing."""
        held: dict[int, int] = {}
        for e in self._store.values():
            for bid in e.block_ids:
                held[bid] = held.get(bid, 0) + 1
        return sum(1 for bid, n in held.items()
                   if self._mgr.refcount(bid) == n)

    def evict_until(self, free_target: int) -> int:
        """Pressure eviction: drop LRU-oldest entries until the
        manager's free supply reaches ``free_target`` or the store is
        empty; returns entries evicted (per-eviction byte sizes
        accumulate in ``bytes_evicted``, measured by
        ``entry_nbytes``).  Only blocks whose refcount
        hits zero (cold — held by no active request) actually return
        memory, so a hot shared prefix costs nothing to "evict" and
        frees nothing: the engine keeps escalating to preemption."""
        evicted = 0
        while self._store and self._mgr.free < free_target:
            self._evict_oldest()
            evicted += 1
        return evicted

    def flush(self) -> int:
        """Drop every entry (engine shutdown / tests)."""
        n = 0
        while self._store:
            self._evict_oldest()
            n += 1
        return n
