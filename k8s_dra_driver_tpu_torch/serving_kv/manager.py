"""Host-side ledger of paged KV-cache blocks.

The port's own copy of the JAX package's numpy-only block ledger
(``k8s_dra_driver_tpu/serving_kv/manager.py``), kept line for line so
the two engines allocate, share and evict identically.  Every block
is ``block_size`` token rows of per-layer K/V; the device pool itself
(``models/decode.init_paged_pool``) is a plain
``[n_blocks, block_size, H_kv, D]`` tensor family — ALL ownership
state lives here, in plain numpy, so allocation decisions never touch
the device.

Semantics (PagedAttention, Kwon et al., SOSP 2023):

- **Refcounts, not owners.**  A block with refcount 1 is privately
  owned (writable in place); refcount >= 2 means it is shared between
  an active request and/or prefix-store entries and must be
  copy-on-write'd before any write (``writable``).  Sharing a prefix
  is ``share`` — a refcount bump, zero bytes moved.
- **Block 0 is the null block**, permanently pinned: free/stale slot
  rows of the engine's block tables point at it, so full-batch decode
  dispatch stays static-shape (dead rows write there harmlessly and
  no live row ever reads it through the position mask).
- **Best-fit contiguous runs.**  ``alloc`` prefers the smallest free
  run that fits (ties to the lowest index), the supply-ledger
  anti-fragmentation rule, and falls back to scattered lowest-index
  blocks — correct either way, since block tables indirect every
  access; contiguity is a locality preference, not a requirement.
- **Seizure** (``seize_free``/``release_seized``) is the fault hook
  that pins the free-block supply to zero mid-decode; seized blocks
  are accounted separately so occupancy views stay honest during the
  wave.
"""

from __future__ import annotations

import numpy as np

#: block id every dead/unfilled table row points at; never allocated,
#: never freed, never read by a live (position-masked) query row.
NULL_BLOCK = 0


class BlocksExhausted(RuntimeError):
    """Allocation could not be satisfied — raised only after the
    caller's own fallbacks (cold-entry eviction, slot preemption)
    have been exhausted, or by ``alloc`` for the caller to trigger
    them."""


def _free_runs(free_idx: np.ndarray) -> list[np.ndarray]:
    """Split a sorted index array into maximal contiguous runs."""
    if free_idx.size == 0:
        return []
    cuts = np.nonzero(np.diff(free_idx) > 1)[0] + 1
    return np.split(free_idx, cuts)


class KVBlockManager:
    """Refcounted ledger over ``n_blocks`` KV blocks of
    ``block_size`` token rows each (block 0 reserved as the null
    block)."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (one is the null block), got "
                f"{n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got "
                             f"{block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._ref = np.zeros(n_blocks, np.int32)
        self._ref[NULL_BLOCK] = 1               # permanently pinned
        self._seized: list[int] = []
        # lifetime counters (engine stats / metrics)
        self.allocs_total = 0
        self.alloc_failures = 0
        self.cow_copies_total = 0
        self.spec_trims_total = 0

    # -- views ------------------------------------------------------------

    @property
    def free(self) -> int:
        return int((self._ref == 0).sum())

    @property
    def used(self) -> int:
        """Blocks holding live K/V (null block excluded)."""
        return self.n_blocks - 1 - self.free - len(self._seized)

    @property
    def cow_shared(self) -> int:
        """Blocks currently shared (refcount >= 2, null excluded)."""
        return int((self._ref[1:] > 1).sum())

    def refcount(self, bid: int) -> int:
        return int(self._ref[bid])

    def writable(self, bid: int) -> bool:
        """Privately owned — safe to write in place.  A shared block
        (refcount >= 2) must be copy-on-write'd first; callers count
        the copy via ``note_cow_copy``."""
        if bid == NULL_BLOCK:
            raise ValueError("the null block is never writable")
        return int(self._ref[bid]) == 1

    def note_cow_copy(self) -> None:
        self.cow_copies_total += 1

    def view(self) -> dict:
        """Fragmentation + occupancy snapshot (the supply-ledger
        ``view`` shape at block granularity)."""
        runs = _free_runs(np.nonzero(self._ref == 0)[0])
        return {
            "total_blocks": self.n_blocks - 1,
            "free_blocks": self.free,
            "used_blocks": self.used,
            "cow_shared_blocks": self.cow_shared,
            "seized_blocks": len(self._seized),
            "free_runs": len(runs),
            "largest_free_run": max((len(r) for r in runs), default=0),
        }

    # -- allocate / share / free ------------------------------------------

    def _pick(self, n: int, free_idx: np.ndarray) -> list[int]:
        """Best-fit: the smallest contiguous free run that holds all
        ``n`` (ties to the lowest start index); scattered
        lowest-index blocks when no single run fits."""
        runs = _free_runs(free_idx)
        fits = [r for r in runs if r.size >= n]
        if fits:
            best = min(fits, key=lambda r: (r.size, int(r[0])))
            return [int(i) for i in best[:n]]
        return [int(i) for i in free_idx[:n]]

    def alloc(self, n: int) -> list[int]:
        """Claim ``n`` blocks (refcount 1 each); raises
        :class:`BlocksExhausted` without partial allocation when the
        free supply is short — the caller's cue to evict or preempt."""
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        free_idx = np.nonzero(self._ref == 0)[0]
        if free_idx.size < n:
            self.alloc_failures += 1
            raise BlocksExhausted(
                f"{n} blocks requested, {free_idx.size} free")
        ids = self._pick(n, free_idx)
        self._ref[ids] = 1
        self.allocs_total += n
        return ids

    def share(self, ids) -> None:
        """Refcount bump per block — the zero-copy half of CoW
        prefix sharing.  Only live blocks can be shared."""
        for bid in ids:
            if bid == NULL_BLOCK:
                raise ValueError("cannot share the null block")
            if self._ref[bid] < 1:
                raise RuntimeError(f"share of free block {bid}")
            self._ref[bid] += 1

    def free_blocks(self, ids) -> int:
        """Drop one reference per block; returns how many blocks
        actually returned to the free pool (refcount hit zero) —
        shared blocks survive their other holders."""
        freed = 0
        for bid in ids:
            if bid == NULL_BLOCK:
                raise ValueError("cannot free the null block")
            if self._ref[bid] < 1:
                raise RuntimeError(f"double free of block {bid}")
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                freed += 1
        return freed

    def trim_tail(self, blocks: list, keep: int) -> list:
        """Speculative-decode rollback primitive: release every block
        past index ``keep`` in a slot's block list — the window-
        scratch blocks whose draft rows the verify stage rejected.
        The list is shortened IN PLACE, one reference per trimmed
        block is dropped, and the trimmed ids are returned so the
        caller can null its table rows.  A pure ledger edit: no pool
        bytes move, which is the whole point — rejected-draft
        rollback is a block-table edit, never a KV rewrite."""
        if keep < 0:
            raise ValueError(f"keep must be >= 0, got {keep}")
        dropped = blocks[keep:]
        if dropped:
            del blocks[keep:]
            self.free_blocks(dropped)
            self.spec_trims_total += len(dropped)
        return dropped

    # -- fault hook (kv_exhaust) -------------------------------------------

    def seize_free(self) -> int:
        """Pin every currently-free block (the ``kv_exhaust`` fault):
        the supply drops to zero until ``release_seized``.  Idempotent
        accumulation — a second seizure mid-wave grabs whatever freed
        in between."""
        ids = [int(i) for i in np.nonzero(self._ref == 0)[0]]
        self._ref[ids] = 1
        self._seized.extend(ids)
        return len(ids)

    def release_seized(self) -> int:
        """Return every seized block to the free pool."""
        ids, self._seized = self._seized, []
        for bid in ids:
            self._ref[bid] -= 1
        return len(ids)
