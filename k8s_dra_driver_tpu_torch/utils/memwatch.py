"""Per-component device-memory accounting for the fleet.

The port's copy of ``k8s_dra_driver_tpu/utils/memwatch.py``.  Every
resident byte on a serving card belongs to a component an operator can
name — model params, the paged-KV pool, prefix-cache entries, the
adapter pool, the host arena of the KV tiers — and MemWatch is a ledger
of ``(component, unit)`` -> bytes gauges (unit = replica or gang name),
reconciled against the device allocator's own view:

- **on the card** (``device="cuda"``, the default):
  ``torch.cuda.memory_stats(device)["allocated_bytes.all.current"]``,
  the bytes of live tensors (the counterpart of JAX's
  ``bytes_in_use``; the caching allocator's ``reserved_bytes`` also
  holds freed blocks it keeps for reuse, which no component owns), is
  ground truth and ``tpu_mem_accounted_frac`` reports how much of it
  the ledger explains;
- **on the CPU** (``device="cpu"``, asked for explicitly): no
  allocator view, so the ledger total stands in as the denominator —
  the same code path runs, the fraction reflects self-consistency.

``MemWatch(device="cuda")`` on a machine without a card raises
(utils/device.py ``resolve_device``); it never falls back to the
ledger.  Exposition is manual text format, byte-equal to the reference
module's for the same ledger and source, and ``render_all``-compatible.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device
from .metrics import expo_line

__all__ = ["MemWatch", "tree_nbytes"]


def tree_nbytes(tree) -> int:
    """Total bytes across a nest of tensors: dicts, lists, tuples,
    dataclasses and objects with ``tensors()`` (the port's cache and
    pool objects) are walked; a tensor counts ``numel() *
    element_size()``, a numpy array its ``nbytes``; anything else (a
    Python int such as a cache's ``pos``, None) counts zero — the
    accountant must never crash the code it watches."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (np.ndarray, np.generic)):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    tensors = getattr(tree, "tensors", None)
    if callable(tensors):
        return sum(tree_nbytes(t) for t in tensors())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tree_nbytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


class MemWatch:
    """The per-component byte ledger (module docstring).

    ``account()`` is idempotent per (component, unit) — callers set
    levels, gauge-style, from wherever the truth lives: the gateway's
    per-step fold for each replica's engine, a probe for everything at
    once.  ``device`` is the card whose allocator the ledger is held
    against (``"cuda"`` by default) or ``"cpu"`` for the ledger-only
    reconciliation.
    """

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._ledger: dict[tuple[str, str], int] = {}

    # -- accounting -----------------------------------------------

    def account(self, component: str, nbytes: int,
                unit: str = "fleet") -> int:
        """Set the byte level for one (component, unit) cell."""
        n = max(int(nbytes), 0)
        self._ledger[(str(component), str(unit))] = n
        return n

    def account_params(self, tree, component: str = "model_params",
                       unit: str = "fleet") -> int:
        """Account a parameter (or optimizer-state) nest."""
        return self.account(component, tree_nbytes(tree), unit)

    def account_engine(self, engine, unit: str) -> int:
        """Account one serving engine's resident components: params,
        the paged-KV pool (full reservation — the pool is allocated up
        front regardless of occupancy), dense prefix-cache entries
        (paged prefixes live inside the pool and must not be
        double-counted), the adapter pool (also a full up-front
        reservation) and the host arena of a tiered prefix store.
        Returns the engine's accounted total."""
        total = self.account_params(
            getattr(engine, "params", None), "model_params", unit)
        pool = getattr(engine, "pool", None)
        if pool is not None:
            total += self.account("paged_kv_pool", tree_nbytes(pool),
                                  unit)
        prefix = getattr(engine, "_prefix", None)
        store = getattr(prefix, "_store", None)
        if store is not None and pool is None:
            total += self.account("prefix_cache", tree_nbytes(store),
                                  unit)
        apool = getattr(engine, "adapter_pool", None)
        if apool is not None:
            total += self.account("adapter_pool",
                                  apool.accounted_bytes(), unit)
        arena = getattr(prefix, "host_arena_bytes", None)
        if arena is not None:
            # tiered store (serving_kv/tiers.py): demoted slabs are
            # host memory the pool reservation does not cover
            total += self.account("kv_host_arena", arena(), unit)
        return total

    def account_compile_cache(self, cache_dir=None) -> int:
        """Account the kernel build directory (ops/_build.py,
        ``build/cuda/`` at the checkout root), the port's counterpart of
        the XLA compile cache: host bytes that survive restarts."""
        from ..ops import _build

        root = Path(cache_dir or _build._BUILD_ROOT)
        total = 0
        if root.is_dir():
            for p in root.rglob("*"):
                try:
                    if p.is_file():
                        total += p.stat().st_size
                except OSError:
                    continue
        return self.account("compile_cache", total, unit="host")

    def forget(self, unit: str) -> None:
        """Drop every cell for one unit (a replica that left the pool
        must stop reporting stale bytes)."""
        for key in [k for k in self._ledger if k[1] == unit]:
            del self._ledger[key]

    # -- reconciliation -------------------------------------------

    def accounted_bytes(self) -> int:
        return sum(self._ledger.values())

    def device_bytes_in_use(self):
        """(bytes, source): the card allocator's live-tensor bytes with
        source ``"device"``; on the CPU the ledger total with source
        ``"ledger"``."""
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            return int(stats.get("allocated_bytes.all.current", 0)), \
                "device"
        return self.accounted_bytes(), "ledger"

    def accounted_frac(self) -> float:
        """Ledger coverage of the allocator's resident bytes; 1.0 on the
        CPU (ledger vs itself) and capped at 1.0 — double-counting must
        read as full, not >100%."""
        device, source = self.device_bytes_in_use()
        if source == "ledger" or device <= 0:
            return 1.0
        return min(self.accounted_bytes() / device, 1.0)

    # -- exposition -----------------------------------------------

    def snapshot(self) -> dict:
        device, source = self.device_bytes_in_use()
        return {
            "components": {
                f"{comp}/{unit}": n
                for (comp, unit), n in sorted(self._ledger.items())},
            "accounted_bytes": self.accounted_bytes(),
            "device_bytes_in_use": device,
            "device_source": source,
            "accounted_frac": self.accounted_frac(),
        }

    def render(self) -> bytes:
        """Text exposition (``render_all``-compatible); HELP/TYPE
        headers always emit, so a fresh instance shows every family.
        The texts are the reference module's, word for word."""
        device, source = self.device_bytes_in_use()
        out = [
            "# HELP tpu_mem_component_bytes Resident bytes per "
            "accounted component per unit (replica/gang/host)\n",
            "# TYPE tpu_mem_component_bytes gauge\n",
        ]
        for (comp, unit), n in sorted(self._ledger.items()):
            out.append(expo_line("tpu_mem_component_bytes",
                                 {"component": comp, "unit": unit}, n))
        out += [
            "# HELP tpu_mem_accounted_bytes Sum of all accounted "
            "component bytes\n",
            "# TYPE tpu_mem_accounted_bytes gauge\n",
            expo_line("tpu_mem_accounted_bytes", None,
                      self.accounted_bytes()),
            "# HELP tpu_mem_device_bytes_in_use Allocator "
            "bytes-in-use (device stats on-chip, ledger total under "
            "the hermetic fallback)\n",
            "# TYPE tpu_mem_device_bytes_in_use gauge\n",
            expo_line("tpu_mem_device_bytes_in_use",
                      {"source": source}, device),
            "# HELP tpu_mem_accounted_frac Fraction of allocator "
            "bytes the component ledger explains (capped at 1.0)\n",
            "# TYPE tpu_mem_accounted_frac gauge\n",
            expo_line("tpu_mem_accounted_frac", None,
                      self.accounted_frac()),
        ]
        return "".join(out).encode()
