"""Paged adapter-weight pool: the serving_kv ledger generalized to
LoRA factors.

The port of ``k8s_dra_driver_tpu/serving_lora/pool.py``.  One card
serves many adapters but only ``n_resident`` fit in device memory at
once, so adapter weights get the paged-KV treatment: one pooled device
buffer per low-rank leaf (``[S, ...leaf shape]``, S = n_resident + 1)
plus a host-side refcounted ledger deciding which adapter owns which
slot (the port's own ``serving_kv/manager.py`` ``KVBlockManager`` at
block_size=1: a slot is one block).  Slot 0 is the permanently pinned
null adapter: its buffers stay zero, so base-model rows gather a zero
delta and pay one masked add (the S-LoRA / Punica batched
heterogeneous shape).

Refcounts mirror paged KV:

- resident          -> refcount 1 (the pool's own reference);
- pinned (decoding) -> ``acquire`` bumps via ``share``, ``release``
  drops: a slot with rows decoding on it is never evicted;
- evictable         -> refcount back to 1 and not slot 0;
- eviction          -> the least recently used cold adapter, freed
  when a cold load finds no free slot.

The buffers are allocated once, on the pool's device, and never
replaced: a cold load writes its slot in place (``buf[slot].copy_``),
so the fused block's CUDA graphs, which read them at fixed addresses,
see every load without a recapture.  On the card a load's host staging
tensors are pinned and copied on the current stream, after any block
already queued there; each load keeps its staging tensors until an
event recorded after its copies has passed.

Leaves come from an in-memory ``{leaf name: array}`` tree or a
``fetch(name)`` callable (:func:`checkpoint_source` streams them from a
sharded checkpoint, parallel/resharding.py); names are
``layers/<i>/<wq|wo>/<A|B>`` and are validated against
``models/layouts.py``'s ``lora_rules`` at registration.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import torch

from ..models.layouts import lora_rules
from ..parallel.mesh import P, spec_block
from ..serving_kv.manager import NULL_BLOCK, BlocksExhausted, KVBlockManager
from ..utils.device import resolve_device

__all__ = ["LORA_RULES", "AdapterManifest", "AdapterPool", "adapter_leaves",
           "checkpoint_source", "make_adapter", "shard_lora_buffers"]

#: the leaf patterns of ``models/layouts.py``'s ``lora_rules``: an
#: adapter targets wq and wo only.  K/V projections are left out by
#: design, so prompt K/V rows and every shared prefix block stay
#: adapter-independent and prefix sharing works across adapters.  An
#: unmatched leaf is an error.
LORA_RULES = tuple(pattern for pattern, _ in lora_rules(None))

#: leaf tails per layer, in buffer order: the A/B factors of the wq
#: delta (added before RoPE) and of the wo delta
_LEAF_TAILS = ("wq/A", "wq/B", "wo/A", "wo/B")


def adapter_leaves(cfg, rank: int):
    """Yield ``(layer, leaf_idx, name, shape)`` for every low-rank leaf
    of one adapter on ``cfg``: the one definition of the adapter layout
    (pool buffers, manifests and the rule check all walk it)."""
    d, h, k = cfg.d_model, cfg.n_heads, cfg.d_head
    shapes = ((d, rank), (rank, h, k), (h, k, rank), (rank, d))
    for i in range(cfg.n_layers):
        for j, (tail, shape) in enumerate(zip(_LEAF_TAILS, shapes)):
            yield i, j, f"layers/{i}/{tail}", shape


def make_adapter(cfg, rank: int, seed: int, scale: float = 0.05) -> dict:
    """Deterministic in-memory adapter source: ``{leaf name: float32
    array}`` with both factors non-zero (a zero B would alias the base
    model), from numpy's generator at ``seed``, so the same adapter
    can be regenerated anywhere byte for byte."""
    rng = np.random.default_rng(seed)
    return {name: (scale * rng.standard_normal(shape)).astype(np.float32)
            for _, _, name, shape in adapter_leaves(cfg, rank)}


def checkpoint_source(ckpt, step: int, prefix: str = "params/"):
    """Streaming cold-load source over a sharded checkpoint
    (parallel/resharding.py ``ShardedCheckpointer``): each leaf is ONE
    verified ``read_slice`` (only the shard files overlapping that leaf
    are opened), so loading one adapter never reads the full
    checkpoint."""
    def fetch(name: str):
        return ckpt.read_slice(int(step), prefix + name)
    return fetch


@dataclasses.dataclass(frozen=True)
class AdapterManifest:
    """One registered adapter: identity, owner and where its leaves
    come from.  ``source`` is a ``{leaf name: array}`` dict or a
    ``fetch(leaf name) -> array`` callable; registration checks the
    names, the cold load fetches and checks the shapes."""

    name: str
    rank: int
    tenant: str = "-"
    source: Any = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("adapter name must be non-empty")
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self.source is None:
            raise ValueError(f"adapter {self.name!r} has no source")

    def fetch(self, leaf: str):
        if callable(self.source):
            return self.source(leaf)
        return self.source[leaf]


class AdapterPool:
    """The paged adapter-weight pool (module docstring).

    Device state is ``buffers``: per layer a 4-tuple of pooled tensors
    ``(aq [S,d,r], bq [S,r,H,K], ao [S,H,K,r], bo [S,r,d])`` in
    ``cfg.dtype`` on ``device``, the decode functions' ``lora[1]``
    beside each row's slot id.  Allocated once; loads write in place.
    """

    def __init__(self, cfg, rank: int, n_resident: int, device="cuda"):
        if n_resident < 1:
            raise ValueError(f"need >= 1 resident adapter slot, got "
                             f"{n_resident}")
        self.cfg = cfg
        self.rank = int(rank)
        self.n_resident = int(n_resident)
        self.device = resolve_device(device)
        # slot ledger: block 0 is the null adapter (NULL_BLOCK, pinned
        # by the manager itself)
        self.ledger = KVBlockManager(self.n_resident + 1, 1)
        s = self.n_resident + 1
        self._buffers = [[torch.zeros((s,) + shape, dtype=cfg.dtype,
                                      device=self.device)
                          for _, _, _, shape in leaves]
                         for leaves in _per_layer(adapter_leaves(cfg,
                                                                 self.rank))]
        self._rules = tuple(re.compile(pat) for pat, _ in lora_rules(cfg))
        self._manifests: dict[str, AdapterManifest] = {}
        self._slot: dict[str, int] = {}
        self._touch: dict[str, int] = {}
        self._clock = 0
        self._storm: list[int] = []
        # (event, pinned staging tensors) of cold loads whose copies may
        # still be queued on the card
        self._inflight: list[tuple[torch.cuda.Event, list]] = []
        self.hits_total = 0
        self.cold_loads_total = 0
        self.evictions_total = 0

    # -- layout ----------------------------------------------------

    @property
    def buffers(self) -> tuple:
        """The pooled device buffers as the decode ``lora[1]`` tree:
        per layer ``(aq, bq, ao, bo)``, the same tensors for the pool's
        whole life."""
        return tuple(tuple(layer) for layer in self._buffers)

    @property
    def bytes_per_slot(self) -> int:
        """Device bytes one resident adapter occupies (every slot has
        the pool's rank)."""
        return int(sum(b[0].numel() * b.element_size()
                       for layer in self._buffers for b in layer))

    def accounted_bytes(self) -> int:
        """The whole pool's reservation, allocated up front whatever is
        resident."""
        return int(sum(b.numel() * b.element_size()
                       for layer in self._buffers for b in layer))

    # -- registration ----------------------------------------------

    def register(self, manifest: AdapterManifest) -> None:
        """Admit an adapter to the catalog (no device work): its rank
        must be the pool's, and every leaf name must match a
        ``LORA_RULES`` entry."""
        if manifest.rank != self.rank:
            raise ValueError(
                f"adapter {manifest.name!r} rank {manifest.rank} != pool "
                f"rank {self.rank} (rank is a static pool shape)")
        for _, _, name, _ in adapter_leaves(self.cfg, self.rank):
            if not any(r.search(name) for r in self._rules):
                raise ValueError(f"adapter leaf {name!r} matches no "
                                 f"LORA_RULES entry")
        self._manifests[manifest.name] = manifest

    def known(self, name: str) -> bool:
        return name in self._manifests

    def manifest(self, name: str) -> AdapterManifest:
        return self._manifests[name]

    # -- residency -------------------------------------------------

    def slot_of(self, name: str | None) -> int | None:
        """Resident slot id, NULL_BLOCK for the base model, None when
        not resident."""
        if name is None:
            return NULL_BLOCK
        return self._slot.get(name)

    def resident(self) -> tuple[str, ...]:
        return tuple(sorted(self._slot))

    def evictable(self) -> tuple[str, ...]:
        """Resident adapters with no pins (refcount back at the pool's
        own reference), coldest first."""
        cold = [n for n, s in self._slot.items()
                if self.ledger.refcount(s) == 1]
        return tuple(sorted(cold, key=lambda n: self._touch[n]))

    def headroom_slots(self) -> int:
        """Slots a new adapter could claim without blocking: free plus
        evictable."""
        return self.ledger.free + len(self.evictable())

    def can_admit(self, name: str | None) -> bool:
        """Could a request for ``name`` be bound here: registered and
        resident or claimable.  The engine's refill gate also counts
        the cold loads its round already plans."""
        if name is None:
            return True
        if name not in self._manifests:
            return False
        return name in self._slot or self.headroom_slots() >= 1

    # -- pin lifecycle ---------------------------------------------

    def acquire(self, name: str | None) -> int:
        """Pin ``name`` for a decoding row and return its slot.

        Resident: a refcount bump, an LRU touch, a hit.  Cold: claim a
        slot (evicting the least recently used cold adapter under
        pressure), load the leaves into it, then pin.  Raises
        ``KeyError`` for an unregistered adapter and ``BlocksExhausted``
        when every slot is pinned (the engine's admission gate keeps
        that from happening)."""
        if name is None:
            return NULL_BLOCK
        manifest = self._manifests[name]
        self._clock += 1
        slot = self._slot.get(name)
        if slot is not None:
            self.hits_total += 1
            self.ledger.share([slot])
            self._touch[name] = self._clock
            return slot
        slot = self._claim_slot()
        self._load(slot, manifest)
        self._slot[name] = slot
        self._touch[name] = self._clock
        self.cold_loads_total += 1
        self.ledger.share([slot])
        return slot

    def release(self, slot: int) -> None:
        """Drop one pin.  The adapter stays resident until eviction
        pressure claims its slot."""
        if slot != NULL_BLOCK:
            self.ledger.free_blocks([slot])

    def evict(self, name: str) -> bool:
        """Evict one cold resident adapter; False when it is pinned or
        absent.  The slot's bytes stay until the next load overwrites
        them: no row reads a slot it has not pinned."""
        slot = self._slot.get(name)
        if slot is None or self.ledger.refcount(slot) != 1:
            return False
        self.ledger.free_blocks([slot])
        del self._slot[name]
        self.evictions_total += 1
        return True

    def _claim_slot(self) -> int:
        try:
            return self.ledger.alloc(1)[0]
        except BlocksExhausted:
            for victim in self.evictable():
                if self.evict(victim):
                    return self.ledger.alloc(1)[0]
            raise

    def _load(self, slot: int, manifest: AdapterManifest) -> None:
        """Write one adapter's leaves into ``slot`` of the pooled
        buffers, in place.  Every shape is checked against
        ``adapter_leaves`` before any buffer is touched.  On the card
        the leaves go through pinned host tensors, copied without a
        host wait on the current stream (after whatever block is queued
        there), and kept until those copies have run."""
        staged = []
        for li, lj, name, shape in adapter_leaves(self.cfg, self.rank):
            arr = np.asarray(manifest.fetch(name))
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(
                    f"adapter {manifest.name!r} leaf {name!r} has shape "
                    f"{tuple(arr.shape)}, want {tuple(shape)}")
            staged.append((li, lj, torch.as_tensor(arr).to(self.cfg.dtype)))
        if self.device.type != "cuda":
            for li, lj, host in staged:
                self._buffers[li][lj][slot].copy_(host)
            return
        self._inflight = [(ev, ts) for ev, ts in self._inflight
                          if not ev.query()]
        pinned = [host.pin_memory() for _, _, host in staged]
        for (li, lj, _), host in zip(staged, pinned):
            self._buffers[li][lj][slot].copy_(host, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._inflight.append((done, pinned))

    # -- tenancy / accounting --------------------------------------

    def resident_bytes(self, tenant: str | None = None) -> int:
        """Resident adapter bytes, optionally one tenant's share."""
        names = (self._slot if tenant is None else
                 [n for n in self._slot
                  if self._manifests[n].tenant == tenant])
        return len(names) * self.bytes_per_slot

    def cold_names(self, tenant: str) -> tuple[str, ...]:
        """One tenant's evictable residents, coldest first."""
        return tuple(n for n in self.evictable()
                     if self._manifests[n].tenant == tenant)

    # -- fault injection (adapter_evict_storm) ---------------------

    @property
    def storm_active(self) -> bool:
        return bool(self._storm)

    def seize_to_one(self) -> int:
        """The eviction-storm fault: evict every cold adapter, then pin
        all but one free slot, so the pool serves with a single usable
        slot until ``release_storm``.  Accumulating and idempotent."""
        for victim in self.evictable():
            self.evict(victim)
        while self.ledger.free > 1:
            self._storm.extend(self.ledger.alloc(1))
        return len(self._storm)

    def release_storm(self) -> int:
        ids, self._storm = self._storm, []
        if ids:
            self.ledger.free_blocks(ids)
        return len(ids)

    # -- observability ---------------------------------------------

    def snapshot(self) -> dict:
        return {
            "pool_slots": self.n_resident,
            "resident": list(self.resident()),
            "free_slots": self.ledger.free,
            "headroom_slots": self.headroom_slots(),
            "bytes_per_slot": self.bytes_per_slot,
            "hits_total": self.hits_total,
            "cold_loads_total": self.cold_loads_total,
            "evictions_total": self.evictions_total,
            "storm_active": self.storm_active,
        }


def shard_lora_buffers(buffers, mesh, copy: bool = True) -> tuple:
    """This rank's blocks of an :class:`AdapterPool`'s ``buffers`` (the
    decode ``lora[1]`` tree) for decoding under ``mesh``: each leaf cut
    by ``models/layouts.py``'s ``lora_rules`` with the spec shifted one
    dim right for the slot axis, so wq's B ``[S, r, H/tp, K]`` and wo's
    A ``[S, H/tp, K, r]`` hold this rank's heads and wq's A and wo's B
    stay whole.  Fresh contiguous tensors, as ``shard_params`` cuts the
    weights; with ``copy=False`` views of the buffers instead, through
    which the pool's in-place loads show (what a serving engine reads:
    the decode gathers ``[slots]`` rows, which a view serves)."""
    rules = lora_rules(None)
    sizes, coords = mesh.spec.axis_sizes(), mesh.coords
    out = []
    for i, layer in enumerate(buffers):
        cut = []
        for tail, buf in zip(_LEAF_TAILS, layer):
            name = f"layers/{i}/{tail}"
            spec = next(s for pat, s in rules if re.search(pat, name))
            bounds = spec_block(buf.shape, P(None, *spec), sizes, coords)
            for dim, (lo, hi) in enumerate(bounds):
                buf = buf.narrow(dim, lo, hi - lo)
            cut.append(buf.clone(memory_format=torch.contiguous_format)
                       if copy else buf)
        out.append(tuple(cut))
    return tuple(out)


def _per_layer(leaves):
    """Group the adapter_leaves stream back into per-layer lists."""
    layers: dict[int, list] = {}
    for li, lj, name, shape in leaves:
        layers.setdefault(li, []).append((li, lj, name, shape))
    return [layers[i] for i in sorted(layers)]
