"""Tiered KV/prefix store: device blocks, host-memory arena, disk spill.

The port's own copy of ``k8s_dra_driver_tpu/serving_kv/tiers.py``.  The
paged store (prefix.py) keeps prefixes on the device only: watermark
eviction destroys a prefix and the next hit recomputes it from tokens.
Here eviction becomes *demotion* down a storage hierarchy:

- **device**: the refcounted block pool (KVBlockManager); entries are
  ordinary :class:`PagedEntry` block-id tuples.
- **host**: a byte-budgeted arena of block-shaped CPU tensors
  (:class:`HostArena`).  ``_evict_oldest`` gathers the entry's K/V
  host-ward BEFORE its device blocks are freed, so an evicted prefix
  survives as bytes.
- **disk**: an optional crc32-checked spill directory
  (:class:`DiskTier`; tmp + fsync + replace + directory fsync).
  Host-arena overflow cascades here; entries survive an engine restart
  and are re-adopted by scanning the file headers at construction.

A prefix hit on a demoted entry *promotes*: the slab's checksum is
verified, it is copied into freshly allocated blocks (the engine's
``paged_adopt_slab``) and re-inserted as a normal device entry, so the
promoted K/V are bitwise the rows that were demoted.  Corruption at any
tier drops that entry loudly (counter + log) and the caller recomputes.

Host slabs are torch CPU tensors (numpy has no bfloat16 of its own).
The checksum and the disk payload read each tensor's bytes in C order,
and the disk header names dtypes as numpy does (``"bfloat16"``,
``"float32"``, ``"int8"``), so a slab file written by either package
loads in the other.  The store keeps :class:`PagedPrefixStore`'s API
(``_store``, ``listeners``, counters); demotion and promotion fire the
listener events ``demote`` / ``demote_disk`` / ``promote``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import zlib
from pathlib import Path

import numpy as np
import torch

from ..utils.atomicio import write_atomic_bytes
from .manager import BlocksExhausted, KVBlockManager
from .prefix import PagedEntry, PagedPrefixStore

log = logging.getLogger(__name__)

#: residency tiers, best first: the routing preference order
TIER_DEVICE = "device"
TIER_HOST = "host"
TIER_DISK = "disk"
TIER_RANK = {TIER_DEVICE: 0, TIER_HOST: 1, TIER_DISK: 2}

#: disk slab header format tag (a schema change must fail loudly
#: instead of promoting garbage)
SLAB_FORMAT = "tpu-dra-kv-slab/1"

#: the disk header's dtype names (numpy's, which the JAX package
#: writes) and the torch dtypes they load as: the model dtypes and the
#: int8 cache's
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


class TierCorruption(RuntimeError):
    """A demoted slab failed its checksum or shape check: the entry is
    unusable and the caller must recompute."""


def _bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes in C order, as a uint8 array (no copy for a
    contiguous CPU tensor)."""
    return t.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def slab_checksum(k: list, v: list) -> int:
    """Chained crc32 over every tensor's bytes, in (k..., v...) layer
    order.  Chaining equals the crc of the concatenated bytes, so the
    same value checks a host slab (per tensor) and its disk payload
    (one blob)."""
    crc = 0
    for t in list(k) + list(v):
        crc = zlib.crc32(_bytes(t), crc)
    return crc


@dataclasses.dataclass
class HostSlab:
    """One demoted prefix: ``length`` valid token rows as per-layer
    block-shaped CPU tensors ([n_blocks, block_size, H_kv, D] each, any
    dtype) plus the crc32 stamped at demotion."""

    length: int
    k: list
    v: list
    crc: int

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(t) for t in self.k + self.v)

    def verify(self) -> bool:
        return slab_checksum(self.k, self.v) == self.crc


class HostArena:
    """Byte-budgeted LRU arena of host slabs (dict insertion order is
    the LRU order).  ``put`` returns the slabs it displaced, oldest
    first, possibly the new one when it alone exceeds the budget, so
    the owner can cascade them to disk or drop them."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes < 1:
            raise ValueError("host arena needs a positive byte budget")
        self.capacity_bytes = int(capacity_bytes)
        self._slabs: dict[tuple, HostSlab] = {}
        self.used_bytes = 0

    def __len__(self) -> int:
        return len(self._slabs)

    def __contains__(self, key) -> bool:
        return key in self._slabs

    def keys(self):
        return self._slabs.keys()

    def get(self, key) -> HostSlab:
        return self._slabs[key]

    def pop(self, key) -> HostSlab:
        slab = self._slabs.pop(key)
        self.used_bytes -= slab.nbytes
        return slab

    def put(self, key, slab: HostSlab) -> list[tuple]:
        """Store ``slab`` under ``key``; returns displaced ``(key,
        slab)`` pairs (LRU-oldest first)."""
        if key in self._slabs:
            self.pop(key)
        displaced = []
        if slab.nbytes > self.capacity_bytes:
            return [(key, slab)]       # never fits; caller cascades
        while self.used_bytes + slab.nbytes > self.capacity_bytes:
            old_key = next(iter(self._slabs))
            displaced.append((old_key, self.pop(old_key)))
        self._slabs[key] = slab
        self.used_bytes += slab.nbytes
        return displaced


class DiskTier:
    """crc32-checked slab files under a spill directory.

    Every write is atomic (sibling tmp + data fsync + ``os.replace`` +
    directory fsync), so a crash mid-demotion leaves the old file or
    none, never a torn slab.  ``scan()`` re-adopts surviving entries
    after a restart from their headers alone (the payload is read when
    a hit promotes)."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key) -> Path:
        h = hashlib.sha256(
            np.asarray(key, np.int64).tobytes()).hexdigest()[:32]
        return self.root / f"slab-{h}.kv"

    def put(self, key, slab: HostSlab) -> None:
        header = {
            "format": SLAB_FORMAT,
            "tokens": [int(t) for t in key],
            "length": int(slab.length),
            "layers": len(slab.k),
            "shape": list(slab.k[0].shape),
            "dtype": _DTYPE_NAMES[slab.k[0].dtype],
            "crc": int(slab.crc),
        }
        payload = b"".join(_bytes(t).tobytes() for t in slab.k + slab.v)
        blob = json.dumps(header).encode() + b"\n" + payload
        write_atomic_bytes(self._path(key), blob)

    def load(self, key) -> HostSlab:
        """Read and verify one slab; :class:`TierCorruption` on any
        damage (unreadable, bad header, crc mismatch)."""
        path = self._path(key)
        try:
            blob = path.read_bytes()
            head, payload = blob.split(b"\n", 1)
            header = json.loads(head)
            if header["format"] != SLAB_FORMAT:
                raise ValueError(f"format {header['format']!r}")
            if zlib.crc32(payload) != header["crc"]:
                raise ValueError("crc mismatch")
            shape = tuple(header["shape"])
            dtype = _DTYPES[header["dtype"]]
            layers = int(header["layers"])
            itemsize = torch.empty((), dtype=dtype).element_size()
            per = int(np.prod(shape)) * itemsize
            if len(payload) != 2 * layers * per:
                raise ValueError("payload size mismatch")
            buf = bytearray(payload)
            tensors = [torch.frombuffer(buf, dtype=dtype,
                                        count=per // itemsize,
                                        offset=i * per).reshape(shape)
                       for i in range(2 * layers)]
        except (OSError, ValueError, KeyError) as e:
            raise TierCorruption(
                f"disk slab for {len(key)}-token key: {e}") from e
        return HostSlab(length=int(header["length"]),
                        k=tensors[:layers], v=tensors[layers:],
                        crc=int(header["crc"]))

    def pop(self, key) -> None:
        try:
            self._path(key).unlink()
        except OSError:
            pass

    def scan(self) -> dict[tuple, int]:
        """key -> length for every readable header in the spill
        directory (the restart sweep).  A damaged header skips its file;
        payloads are verified at promote time."""
        found: dict[tuple, int] = {}
        for path in sorted(self.root.glob("slab-*.kv")):
            try:
                with open(path, "rb") as f:
                    header = json.loads(f.readline())
                if header["format"] != SLAB_FORMAT:
                    continue
                key = tuple(int(t) for t in header["tokens"])
                found[key] = int(header["length"])
            except (OSError, ValueError, KeyError):
                continue
        return found

    def bytes(self) -> int:
        total = 0
        for path in self.root.glob("slab-*.kv"):
            try:
                total += path.stat().st_size
            except OSError:
                continue
        return total


class TieredKVStore(PagedPrefixStore):
    """A :class:`PagedPrefixStore` whose watermark eviction demotes and
    whose hits promote (module docstring).

    The device halves are the engine's (it owns the pool) and arrive
    through :meth:`bind_engine`:

    - ``gather_fn(entry) -> (k, v)``: block-shaped CPU tensors of the
      entry's valid blocks;
    - ``adopt_fn(k, v) -> block_ids``: copy a slab into freshly
      allocated blocks, returning ids whose allocation references the
      CALLER owns (the store shares then frees them).  Raises
      :class:`BlocksExhausted` under pressure: promotion then falls back
      to recompute and never preempts.

    Unbound, the store evicts as the plain store does.
    """

    def __init__(self, entries: int, manager: KVBlockManager, *,
                 host_bytes: int = 0, spill_dir=None):
        super().__init__(entries, manager)
        self._host = HostArena(host_bytes) if host_bytes else None
        self._disk = DiskTier(spill_dir) if spill_dir else None
        if self._host is None and self._disk is None:
            raise ValueError("tiered store needs host_bytes and/or "
                             "spill_dir; use PagedPrefixStore for "
                             "single-tier")
        self._gather = None
        self._adopt = None
        #: key -> (tier, length) for every demoted entry
        self._demoted: dict[tuple, tuple[str, int]] = {}
        if self._disk is not None:
            # restart adoption: entries an earlier engine spilled can be
            # hit again at once (promotion verifies the crc)
            for key, length in self._disk.scan().items():
                self._demoted[key] = (TIER_DISK, length)
        self.tier_hits = 0
        self.promotions = 0
        self.demotions = 0
        self.corrupt_fallbacks = 0
        self.bytes_demoted = 0

    def bind_engine(self, gather_fn, adopt_fn) -> None:
        self._gather = gather_fn
        self._adopt = adopt_fn

    # -- observability ---------------------------------------------

    def host_arena_bytes(self) -> int:
        return self._host.used_bytes if self._host is not None else 0

    def disk_tier_bytes(self) -> int:
        return self._disk.bytes() if self._disk is not None else 0

    def demoted_counts(self) -> dict[str, int]:
        out = {TIER_HOST: 0, TIER_DISK: 0}
        for tier, _ in self._demoted.values():
            out[tier] += 1
        return out

    def tier_counters(self) -> dict[str, int]:
        """Monotonic counters for scrapers."""
        return {"hits": self.tier_hits,
                "promotions": self.promotions,
                "demotions": self.demotions,
                "corrupt_fallbacks": self.corrupt_fallbacks}

    def residency_of(self, key: tuple) -> str | None:
        if key in self._store:
            return TIER_DEVICE
        entry = self._demoted.get(key)
        return entry[0] if entry is not None else None

    def residency(self, prompt: np.ndarray) -> tuple[int, str | None]:
        """(p, tier) of the longest match across ALL tiers: no hit
        accounting, no LRU touch, no promotion (``peek`` stays
        device-only, so the engine's admission arithmetic keeps its
        conservative block counts)."""
        p_dev = self.peek(prompt)
        p_dem, key_dem = self._best_demoted(prompt)
        if key_dem is not None and p_dem > p_dev:
            return p_dem, self._demoted[key_dem][0]
        return p_dev, (TIER_DEVICE if p_dev else None)

    # -- demotion (eviction override) ------------------------------

    def _best_demoted(self, prompt: np.ndarray) -> tuple[int, tuple]:
        """(p, key) over the demoted map, with ``_best_match``'s cap at
        len(prompt)-1."""
        toks = prompt.tolist()
        cap = len(toks) - 1
        best_p, best_key = 0, None
        for key, (_, length) in self._demoted.items():
            p = 0
            for a, b in zip(key[:length], toks[:cap]):
                if a != b:
                    break
                p += 1
            if p > best_p:
                best_p, best_key = p, key
        return best_p, best_key

    def _drop_demoted(self, key: tuple, corrupt: bool = False) -> None:
        """Forget a demoted entry at every tier below the device.  A
        corrupt drop bumps its counter and logs the damage."""
        tier, _ = self._demoted.pop(key, (None, 0))
        if self._host is not None and key in self._host:
            self._host.pop(key)
        if self._disk is not None:
            self._disk.pop(key)
        if corrupt:
            self.corrupt_fallbacks += 1
            log.warning("tiered KV: %s-tier slab for %d-token key "
                        "failed verification; entry dropped, callers "
                        "recompute", tier, len(key))
        self._notify("evict", key)

    def _spill_to_disk(self, key: tuple, slab: HostSlab) -> bool:
        if self._disk is None:
            return False
        try:
            self._disk.put(key, slab)
        except OSError as e:
            log.warning("tiered KV: disk spill failed (%s); entry "
                        "dropped", e)
            return False
        self._demoted[key] = (TIER_DISK, slab.length)
        self._notify("demote_disk", key)
        return True

    def _evict_oldest(self) -> tuple[tuple, PagedEntry, int]:
        """Watermark eviction becomes demotion: gather the coldest
        entry's blocks into a checksummed host slab BEFORE its device
        blocks are freed; host-arena overflow cascades the arena's own
        coldest slabs to disk (or drops them without a disk tier)."""
        key = next(iter(self._store))
        entry = self._store[key]
        demoted = False
        if self._gather is not None:
            try:
                k, v = self._gather(entry)
                slab = HostSlab(length=entry.length, k=k, v=v,
                                crc=slab_checksum(k, v))
            except Exception as e:
                # a device-side fault, not data corruption: evict cold
                # (recompute covers it) and say so
                log.warning("tiered KV: demotion gather failed (%s); "
                            "entry evicted cold", e)
                slab = None
            if slab is not None:
                if self._host is not None:
                    displaced = self._host.put(key, slab)
                else:
                    displaced = [(key, slab)]
                for dkey, dslab in displaced:
                    if not self._spill_to_disk(dkey, dslab):
                        if dkey == key:
                            slab = None
                        else:
                            self._drop_demoted(dkey)
            if slab is not None:
                self._demoted[key] = (
                    (TIER_HOST if self._host is not None
                     and key in self._host else TIER_DISK),
                    entry.length)
                demoted = True
        # the device-side release, as the plain store does it
        self._store.pop(key)
        self._mgr.free_blocks(entry.block_ids)
        nbytes = self.entry_nbytes(entry)
        self.evictions += 1
        self.bytes_evicted += nbytes
        if demoted:
            self.demotions += 1
            self.bytes_demoted += nbytes
            self._notify("demote", key)
        else:
            self._notify("evict", key)
        return key, entry, nbytes

    # -- promotion (hit override) ----------------------------------

    def _promote(self, key: tuple) -> PagedEntry | None:
        """Move a demoted entry back to the device: verify the checksum,
        adopt the slab into fresh blocks, re-insert it as a device
        entry.  None on corruption (entry dropped loudly) or block
        pressure (the entry STAYS demoted; the caller recomputes and a
        later hit may still promote)."""
        tier, _ = self._demoted[key]
        try:
            if tier == TIER_HOST and self._host is not None:
                slab = self._host.get(key)
                if not slab.verify():
                    raise TierCorruption("host slab crc mismatch")
            else:
                slab = self._disk.load(key)
        except TierCorruption:
            self._drop_demoted(key, corrupt=True)
            return None
        if self._adopt is None:
            return None
        try:
            ids = self._adopt(slab.k, slab.v)
        except BlocksExhausted:
            return None
        tokens = np.asarray(key, np.int32)
        self._drop_all_tiers_quiet(key)
        self.insert(tokens, ids, slab.length)
        self._mgr.free_blocks(ids)    # the store's own ref remains
        self.promotions += 1
        self._notify("promote", key)
        return self._store[key]

    def _drop_all_tiers_quiet(self, key: tuple) -> None:
        """Remove a key from the demoted tiers WITHOUT the evict event:
        promotion is a move, and the ``insert`` it precedes announces
        the key as device-resident again."""
        self._demoted.pop(key, None)
        if self._host is not None and key in self._host:
            self._host.pop(key)
        if self._disk is not None:
            self._disk.pop(key)

    # -- the PagedPrefixStore surface, tier-aware ------------------

    def longest_prefix(self, prompt: np.ndarray
                       ) -> tuple[int, PagedEntry | None]:
        """Device entries first; when a demoted entry offers a STRICTLY
        longer match, promote it and serve the hit from its fresh
        blocks.  A failed promotion falls back to what the device still
        holds: shorter reuse or a miss, never a wrong answer."""
        p_dev = self.peek(prompt)
        p_dem, key_dem = self._best_demoted(prompt)
        if key_dem is not None and p_dem > p_dev:
            entry = self._promote(key_dem)
            if entry is not None:
                self.tier_hits += 1
                self.hits += 1
                self.tokens_reused += p_dem
                nbytes = p_dem * self.bytes_per_token
                self.bytes_reused += nbytes
                self._notify_stats("hit", p_dem, nbytes)
                return p_dem, entry
        return super().longest_prefix(prompt)

    def entry(self, tokens: np.ndarray) -> PagedEntry | None:
        """Exact-key fetch, promoting a demoted resident so the caller
        sees ordinary device blocks."""
        found = super().entry(tokens)
        if found is not None:
            return found
        key = tuple(np.asarray(tokens).tolist())
        if key in self._demoted:
            found = self._promote(key)
            if found is not None:
                self.tier_hits += 1
        return found

    def insert(self, tokens: np.ndarray, block_ids, length: int
               ) -> None:
        """A fresh device insert supersedes any demoted copy of the same
        key, so the stale slab is released first."""
        key = tuple(np.asarray(tokens).tolist())
        if key in self._demoted:
            self._drop_all_tiers_quiet(key)
        super().insert(tokens, block_ids, length)

    def drop(self, tokens: np.ndarray) -> None:
        super().drop(tokens)
        key = tuple(np.asarray(tokens).tolist())
        if key in self._demoted:
            self._drop_demoted(key)

    # -- fault hook ------------------------------------------------

    def corrupt_slab(self, rng) -> tuple | None:
        """Flip one bit of one demoted slab (silent media corruption,
        for fault drills).  Host slabs flip a copy swapped into the
        slab; disk slabs are rewritten atomically with the damaged
        payload.  Returns the damaged key, or None when nothing is
        demoted."""
        keys = sorted(self._demoted)
        if not keys:
            return None
        key = keys[rng.randrange(len(keys))]
        tier, _ = self._demoted[key]
        if tier == TIER_HOST and self._host is not None:
            slab = self._host.get(key)
            t = slab.k[0].clone()
            raw = t.reshape(-1).view(torch.uint8)
            i = rng.randrange(_nbytes(t))
            raw[i] = raw[i] ^ 0x01
            slab.k[0] = t
        elif self._disk is not None:
            path = self._disk._path(key)
            try:
                blob = bytearray(path.read_bytes())
                start = blob.index(b"\n") + 1
                blob[start + rng.randrange(len(blob) - start)] ^= 0x01
                write_atomic_bytes(path, bytes(blob))
            except (OSError, ValueError):
                return None
        else:
            return None
        return key


__all__ = ["SLAB_FORMAT", "TIER_DEVICE", "TIER_HOST", "TIER_DISK",
           "TIER_RANK", "TierCorruption", "HostSlab", "HostArena",
           "DiskTier", "TieredKVStore", "slab_checksum"]
