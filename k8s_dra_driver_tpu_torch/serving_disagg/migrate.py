"""KV migration: copy-on-transfer between replicas.

The port of ``k8s_dra_driver_tpu/serving_disagg/migrate.py``, rewritten
for tensors.  A prompt's K/V computed on a prefill replica must land on
the decode replica's device without recomputing a token.  The
mechanism is the shard/gather-fn pair: ``shard_fn`` places a tensor on
the destination, ``gather_fn`` pulls it to the host.  The port has no
pytree, so the migrator walks the leaves of the two payload types
explicitly: ``KVCache.k``, ``v``, ``k_scale`` and ``v_scale`` (the
scales may be None) and ``PagedKVSlab.k`` and ``v``; ``pos`` and
``block_size`` are Python ints that ride along.

``shard_fn`` always makes a FRESH tensor on the destination, even when
the destination is the source's device: the engines write their caches
in place and a fused engine's CUDA graphs hold their addresses, so a
migrated entry that shared storage with its source could be corrupted
by (or corrupt) the source's next write.  This is the reference's
same-device aliasing rule.

Costs are recorded per event: wall seconds and FULL-BUFFER bytes
(``numel * element_size`` of every leaf: a [1, max_seq] cache moves its
whole allocation, not just the ``pos`` valid rows), and ``pos`` tokens.
The gateway folds the events into ``tpu_gateway_kv_migrations_total`` /
``_kv_bytes_moved_total`` / ``_kv_migrate_seconds``
(gateway/frontend.py).

Sync discipline: copies to a card are asynchronous, so the destination
card is synchronized before the clock is read; otherwise the event
would record the enqueue, not the copy.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..models.serving import PagedKVSlab


def make_kv_shard_and_gather_fns(dest=None):
    """(shard_fn, gather_fn) for K/V leaves: ``dest`` is a device (or
    its name; None = the leaf's own device).  ``shard_fn`` copies a
    leaf into fresh storage on the destination, ``gather_fn`` copies it
    to the CPU."""
    def shard_fn(leaf: torch.Tensor) -> torch.Tensor:
        where = leaf.device if dest is None else torch.device(dest)
        return torch.empty_like(leaf, device=where).copy_(leaf)

    def gather_fn(leaf: torch.Tensor) -> torch.Tensor:
        return leaf.to("cpu", copy=True)

    return shard_fn, gather_fn


def _leaf_lists(entry) -> dict:
    """The tensor-list fields of a ``KVCache`` or ``PagedKVSlab``, by
    field name; a None field (no int8 scales) is left out."""
    names = (("k", "v") if isinstance(entry, PagedKVSlab)
             else ("k", "v", "k_scale", "v_scale"))
    return {n: getattr(entry, n) for n in names
            if getattr(entry, n) is not None}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class KVMigrator:
    """Moves K/V entries and blocks between replicas, with accounting.
    One instance per pool: the counters are the pool's migration ledger
    and ``take_events`` drains per-event samples for the metrics fold
    (each lands exactly once)."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.migrations = 0
        self.bytes_moved = 0
        self.tokens_moved = 0
        self.wall_s = 0.0
        self._events: list[tuple[float, int]] = []
        #: the most recent (wall_s, bytes) sample, kept even after
        #: ``take_events`` drains the ledger — how the handoff span
        #: (serving_disagg/pool.py) attributes the transfer it just
        #: caused
        self.last_event: tuple[float, int] | None = None

    def migrate_entry(self, entry, dest=None):
        """Copy one ``KVCache`` ([1, S]) or ``PagedKVSlab`` onto
        ``dest`` (None = where it is) and return the copy; the source
        entry is untouched (its owner keeps serving hits from it)."""
        t0 = self.clock()
        shard_fn, _ = make_kv_shard_and_gather_fns(dest)
        fields = _leaf_lists(entry)
        moved = {n: [shard_fn(t) for t in lst] for n, lst in fields.items()}
        nbytes = sum(t.numel() * t.element_size()
                     for lst in fields.values() for t in lst)
        out = dataclasses.replace(entry, **moved)
        _sync(moved["k"][0].device)
        wall = self.clock() - t0
        self.migrations += 1
        self.bytes_moved += nbytes
        self.tokens_moved += int(entry.pos)
        self.wall_s += wall
        self.last_event = (wall, nbytes)
        self._events.append((wall, nbytes))
        return out

    def migrate_block(self, block, dest=None):
        """Copy a :class:`~..models.serving.KVBlock`: its K/V onto
        ``dest``, its sampling carry (the request generator's state, a
        CPU byte tensor) cloned where it is — generator states are set
        from the host, never from the card."""
        kv = self.migrate_entry(block.kv, dest)
        carry = None if block.carry is None else block.carry.clone()
        return dataclasses.replace(block, kv=kv, carry=carry)

    def take_events(self) -> list[tuple[float, int]]:
        """Per-migration (wall_s, bytes) samples since the last call —
        consumed, so each lands in the metrics exactly once."""
        events, self._events = self._events, []
        return events

    def stats(self) -> dict:
        return {"migrations": self.migrations,
                "bytes_moved": self.bytes_moved,
                "tokens_moved": self.tokens_moved,
                "wall_s": round(self.wall_s, 6)}


__all__ = ["KVMigrator", "make_kv_shard_and_gather_fns"]
