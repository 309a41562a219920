"""Kernel-plan autotuner: a table of measured choices per shape.

The port of ``k8s_dra_driver_tpu/ops/autotune.py``.  Hand-picked
kernel parameters re-litigate "which plan?" for every new shape with no
measurement discipline attached; this module is the one place that
question is answered:

- a **table** of chosen parameters, keyed ``(kernel, shape-key, dtype,
  backend)``.  The checked-in instance (:data:`DEFAULT_TABLE_PATH`,
  ``autotune_h100.json`` beside this file) is the port's own and holds
  no entries: every kernel runs its heuristic plan until a table
  recorded on the card says otherwise.  The JAX package's v5e table is
  never read;
- a **runtime path** (:meth:`Autotuner.pick`) that is a pure lookup
  plus the kernel's heuristic fallback.  It never measures and never
  touches the device, so it is safe inside CUDA-graph capture (K7's
  plan is picked there, ``models/quant.py`` :func:`pick_int8_tiles`)
  and on the CPU suite, which runs the same selection code;
- a **measurement path** (:meth:`Autotuner.tune`) over the
  differential-median harness (``ops/collectives.py``
  :func:`measure_chain`): every candidate timed, the best *valid* one
  recorded with all runs listed.  Only eager tools call it, never a
  kernel wrapper.

Backend keys name the device (``gpu-nvidia-h100-80gb-hbm3``, ``cpu``),
so a table recorded on one card never configures another, and the CPU
suite falls through to the heuristics unless a test injects entries.
Dtypes are spelled as numpy and JAX name them (``bfloat16``,
``float32``), so a table written by either package reads the same in
the other.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import re
import threading
from typing import Any, Callable

import numpy as np
import torch

#: the port's checked-in table (no entries: heuristics everywhere)
DEFAULT_TABLE_PATH = pathlib.Path(__file__).resolve().parent / \
    "autotune_h100.json"

#: env override so tests and tools can point the singleton elsewhere
TABLE_ENV = "TPU_AUTOTUNE_TABLE"


@functools.cache
def _card_kind(index: int) -> str:
    return torch.cuda.get_device_name(index)


def backend_key() -> str:
    """Normalized backend id for table keys: ``"cpu"`` without a card;
    on a card ``"gpu-"`` plus the current card's name, lowercased with
    every run of other characters as one ``-``, so tables recorded on
    one card model never configure another."""
    if not torch.cuda.is_available():
        return "cpu"
    kind = _card_kind(torch.cuda.current_device()).lower()
    kind = re.sub(r"[^a-z0-9]+", "-", kind).strip("-")
    return kind if kind.startswith("gpu") else f"gpu-{kind}"


def shape_key(**dims) -> str:
    """Canonical shape-key fragment: sorted ``name=value`` pairs with
    ``None`` normalized to 0, e.g. ``g=1,k=1024,m=8,n=32000``.  One
    spelling everywhere, so tools and kernels cannot drift."""
    parts = []
    for name in sorted(dims):
        v = dims[name]
        v = 0 if v is None else v
        parts.append(f"{name}={v}")
    return ",".join(parts)


def dtype_name(dtype) -> str:
    """``bfloat16``/``float32``/... for a torch dtype, a numpy dtype or
    its name: the spelling of JAX's ``jnp.dtype(dtype).name``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    try:
        return np.dtype(dtype).name
    except TypeError:
        if isinstance(dtype, str):
            return dtype        # "bfloat16": no numpy dtype without JAX
        raise


def table_key(kernel: str, key: str, dtype, backend: str) -> str:
    return "|".join([kernel, key, dtype_name(dtype), backend])


@dataclasses.dataclass
class Choice:
    """One resolved selection: the parameters plus where they came
    from (``measured`` = table hit, ``default`` = heuristic)."""

    params: dict[str, Any]
    source: str

    def __getitem__(self, name):
        return self.params[name]


class Autotuner:
    """Table owner.  ``lookup``/``pick`` are cheap and pure;
    ``tune`` measures (eager only) and ``save`` persists."""

    def __init__(self, path: os.PathLike | str | None = None):
        self.path = pathlib.Path(path) if path else None
        self.table: dict[str, dict] = {}
        #: what kernel wrappers derived from this table, by their own
        #: keys (:meth:`memo`); emptied whenever the table changes
        self._memo: dict = {}
        #: :meth:`pick` results by source (a memoized wrapper picks
        #: once a shape), so a run can show which plans it launched
        self.picks = {"measured": 0, "default": 0}
        self._loaded = False
        self._lock = threading.Lock()

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        with self._lock:
            if self._loaded:
                return
            if self.path and self.path.exists():
                try:
                    data = json.loads(self.path.read_text())
                    self.table = dict(data.get("entries", {}))
                except (ValueError, OSError):
                    # a torn table must never take the kernels down:
                    # heuristics are always a valid fallback
                    self.table = {}
            self._loaded = True

    # -- runtime path --------------------------------------------------

    def lookup(self, kernel: str, key: str, dtype,
               backend: str | None = None) -> dict | None:
        self._ensure_loaded()
        backend = backend or backend_key()
        entry = self.table.get(table_key(kernel, key, dtype, backend))
        return dict(entry["params"]) if entry else None

    def pick(self, kernel: str, key: str, dtype,
             default: Callable[[], dict] | dict,
             backend: str | None = None) -> Choice:
        """Table hit wins; otherwise the kernel's deterministic
        heuristic.  Never measures: safe inside graph capture and on
        the CPU suite (the same selection path, another source tag)."""
        hit = self.lookup(kernel, key, dtype, backend)
        if hit is not None:
            self.picks["measured"] += 1
            return Choice(hit, "measured")
        params = default() if callable(default) else dict(default)
        self.picks["default"] += 1
        return Choice(params, "default")

    def memo(self, key, build: Callable[[], Any]):
        """``build()`` once per ``key`` for this table: a kernel
        wrapper's per-shape result of :meth:`pick`, so a launch costs
        one dict lookup.  ``tune`` empties it."""
        try:
            return self._memo[key]
        except KeyError:
            value = self._memo[key] = build()
            return value

    # -- measurement path (eager tools only) ---------------------------

    def tune(self, kernel: str, key: str, dtype,
             candidates: list[dict],
             measure: Callable[[dict], tuple[float, bool]],
             backend: str | None = None) -> dict:
        """Measure every candidate with ``measure(params) ->
        (seconds, valid)`` (callers wrap measure_chain /
        measure_chain_samples so the differential-median discipline
        and artifact rejection apply), record the best *valid* one,
        and return its params.  All runs are kept in the entry so a
        recorded choice stays auditable.  With no valid run the
        fastest invalid one is recorded ``valid=False``: visible,
        never silently promoted."""
        if not candidates:
            raise ValueError("tune() needs at least one candidate")
        self._ensure_loaded()
        backend = backend or backend_key()
        runs = []
        for params in candidates:
            try:
                seconds, valid = measure(dict(params))
            except Exception as e:      # one bad candidate (a plan the
                runs.append({"params": params, "error":  # kernel refuses)
                             f"{type(e).__name__}: {e}"[:300]})
                continue                # must not void the sweep
            runs.append({"params": params,
                         "ms": round(seconds * 1000, 4),
                         "valid": bool(valid)})
        timed = [r for r in runs if "ms" in r]
        if not timed:
            raise RuntimeError(
                f"every candidate errored for {kernel}|{key}: {runs}")
        pool = [r for r in timed if r["valid"]] or timed
        best = min(pool, key=lambda r: r["ms"])
        entry = {"params": best["params"], "ms": best["ms"],
                 "valid": best["valid"], "source": "measured",
                 "runs": runs}
        with self._lock:
            self.table[table_key(kernel, key, dtype, backend)] = entry
            self._memo.clear()
        return dict(best["params"])

    def save(self, path: os.PathLike | str | None = None,
             meta: dict | None = None) -> pathlib.Path:
        self._ensure_loaded()
        path = pathlib.Path(path or self.path)
        payload = {
            "what": ("autotune table: chosen kernel plans per (kernel, "
                     "shape, dtype, backend); consumed by "
                     "ops/autotune.py pick(), recorded by "
                     "Autotuner.tune over the differential-median "
                     "harness (ops/collectives.py) on an idle card"),
            **(meta or {}),
            "entries": self.table,
        }
        path.write_text(json.dumps(payload, indent=1) + "\n")
        return path


_SINGLETON: Autotuner | None = None
_SINGLETON_LOCK = threading.Lock()


def get_autotuner() -> Autotuner:
    """Process-wide table (:data:`DEFAULT_TABLE_PATH` unless
    ``TPU_AUTOTUNE_TABLE`` points elsewhere; read once, at first
    use)."""
    global _SINGLETON
    with _SINGLETON_LOCK:
        if _SINGLETON is None:
            path = os.environ.get(TABLE_ENV) or DEFAULT_TABLE_PATH
            _SINGLETON = Autotuner(path)
        return _SINGLETON


def reset_autotuner() -> None:
    """Drop the singleton (callers that point TPU_AUTOTUNE_TABLE at a
    scratch table call this around the change)."""
    global _SINGLETON
    with _SINGLETON_LOCK:
        _SINGLETON = None


__all__ = ["Autotuner", "Choice", "DEFAULT_TABLE_PATH", "TABLE_ENV",
           "backend_key", "dtype_name", "get_autotuner",
           "reset_autotuner", "shape_key", "table_key"]
