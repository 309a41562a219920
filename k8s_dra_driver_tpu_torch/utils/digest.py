"""Bounded-memory, mergeable streaming quantile digest.

The port's copy of ``k8s_dra_driver_tpu/utils/digest.py``, unchanged in
behaviour.  DDSketch-lineage relative-error sketch (Masson et al.,
VLDB'19): values are binned into geometric buckets
``(gamma^(i-1), gamma^i]`` with ``gamma = (1+alpha)/(1-alpha)``, so any
quantile estimate is within relative error ``alpha`` of a true sample
quantile.

- **mergeable**: merging two digests is bucket-wise count addition,
  and merge-of-parts is byte-identical to the whole-stream digest;
- **bounded memory**: at most ``max_buckets`` occupied buckets — the
  smallest-magnitude buckets collapse first, preserving the tail the
  sketch exists to measure;
- **deterministic serialization**: ``to_json`` sorts keys, so equal
  states produce equal bytes regardless of observation order.

Signed on purpose: SLO margin is negative when missed, so the sketch
keeps mirrored positive/negative bucket stores plus an exact
zero-count rather than the usual positive-only store.
"""

from __future__ import annotations

import json
import math

__all__ = ["QuantileDigest", "DigestBank", "NullDigestBank",
           "DEFAULT_ALPHA", "DEFAULT_MAX_BUCKETS"]

DEFAULT_ALPHA = 0.01
DEFAULT_MAX_BUCKETS = 1024

# magnitudes at or below this are exact zeros for bucketing purposes
# (log() of a true denormal would otherwise mint astronomically
# negative bucket indices)
_ZERO_EPS = 1e-12


class QuantileDigest:
    """One mergeable sketch over a stream of floats."""

    __slots__ = ("alpha", "max_buckets", "count", "total", "vmin",
                 "vmax", "_zero", "_pos", "_neg", "_gamma", "_lg")

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 max_buckets: int = DEFAULT_MAX_BUCKETS):
        if not 0.0 < alpha < 1.0:
            raise ValueError("alpha must be in (0, 1)")
        if max_buckets < 8:
            raise ValueError("max_buckets must be >= 8")
        self.alpha = float(alpha)
        self.max_buckets = int(max_buckets)
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self._gamma)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._zero = 0
        self._pos: dict[int, int] = {}
        self._neg: dict[int, int] = {}

    # -- ingest ---------------------------------------------------

    def observe(self, value: float, n: int = 1) -> None:
        """Fold one value (or ``n`` copies of it) into the sketch.

        NaN is dropped — a poisoned sample must not poison every
        quantile behind it (the same posture as perf_sentinel's
        "unknown, never a crash")."""
        v = float(value)
        if math.isnan(v) or n <= 0:
            return
        self.count += n
        self.total += v * n
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        a = abs(v)
        if a <= _ZERO_EPS or math.isinf(v):
            # +/-inf carries no finite bucket; min/max already keep it
            self._zero += n
            return
        idx = int(math.ceil(math.log(a) / self._lg - 1e-9))
        store = self._pos if v > 0 else self._neg
        store[idx] = store.get(idx, 0) + n
        if len(self._pos) + len(self._neg) > self.max_buckets:
            self._collapse()

    def _rep(self, idx: int) -> float:
        """Bucket representative: midpoint of (gamma^(i-1), gamma^i]
        in relative terms, within alpha of every member."""
        return 2.0 * self._gamma ** idx / (self._gamma + 1.0)

    def _collapse(self) -> None:
        """Merge the smallest-magnitude bucket into its neighbor
        until back under ``max_buckets`` — tails are the payload, so
        accuracy loss lands on the values closest to zero."""
        while len(self._pos) + len(self._neg) > self.max_buckets:
            # side whose lowest-index bucket has the smaller magnitude
            cands = []
            if self._pos:
                lo = min(self._pos)
                cands.append((self._rep(lo), self._pos, lo))
            if self._neg:
                lo = min(self._neg)
                cands.append((self._rep(lo), self._neg, lo))
            _, store, lo = min(cands, key=lambda c: c[0])
            n = store.pop(lo)
            rest = [k for k in store if k > lo]
            if rest:
                store[min(rest)] += n
            else:
                self._zero += n

    # -- merge ----------------------------------------------------

    def merge(self, other: "QuantileDigest") -> None:
        """Fold ``other`` into self (bucket-wise count addition).
        Requires identical ``alpha`` — merging sketches of different
        resolutions silently degrades the advertised error bound."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError("cannot merge digests with different alpha")
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        self._zero += other._zero
        for idx, n in other._pos.items():
            self._pos[idx] = self._pos.get(idx, 0) + n
        for idx, n in other._neg.items():
            self._neg[idx] = self._neg.get(idx, 0) + n
        if len(self._pos) + len(self._neg) > self.max_buckets:
            self._collapse()

    def copy(self) -> "QuantileDigest":
        d = QuantileDigest(self.alpha, self.max_buckets)
        d.merge(self)
        return d

    # -- query ----------------------------------------------------

    def quantile(self, q: float) -> float | None:
        """Value at quantile ``q`` in [0, 1]; None on an empty
        sketch.  Walks buckets most-negative -> zero -> positive and
        clamps into the exact [vmin, vmax] envelope, so q=0/q=1 are
        exact and everything between is within ``alpha`` relative."""
        if self.count == 0:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        target = q * (self.count - 1)
        seen = 0
        for idx in sorted(self._neg, reverse=True):
            seen += self._neg[idx]
            if seen > target:
                return self._clamp(-self._rep(idx))
        seen += self._zero
        if seen > target:
            return self._clamp(0.0)
        for idx in sorted(self._pos):
            seen += self._pos[idx]
            if seen > target:
                return self._clamp(self._rep(idx))
        return self.vmax

    def _clamp(self, v: float) -> float:
        return min(max(v, self.vmin), self.vmax)

    def snapshot(self) -> dict:
        """JSON-safe summary: exact count/sum/min/max plus the four
        fleet quantiles.  Empty sketch -> zeros and null quantiles."""
        out = {"count": self.count,
               "sum": self.total,
               "min": self.vmin if self.count else None,
               "max": self.vmax if self.count else None,
               "alpha": self.alpha}
        for label, q in (("p50", 0.5), ("p90", 0.9),
                         ("p99", 0.99), ("p999", 0.999)):
            out[label] = self.quantile(q)
        return out

    # -- serialization --------------------------------------------

    def to_json(self) -> str:
        """Deterministic: sorted keys, compact separators — equal
        sketch states serialize to equal bytes."""
        return json.dumps({
            "alpha": self.alpha,
            "max_buckets": self.max_buckets,
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "zero": self._zero,
            "pos": {str(k): v for k, v in self._pos.items()},
            "neg": {str(k): v for k, v in self._neg.items()},
        }, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "QuantileDigest":
        d = json.loads(text)
        dig = cls(alpha=d["alpha"], max_buckets=d["max_buckets"])
        dig.count = int(d["count"])
        dig.total = float(d["sum"])
        dig.vmin = math.inf if d["min"] is None else float(d["min"])
        dig.vmax = -math.inf if d["max"] is None else float(d["max"])
        dig._zero = int(d["zero"])
        dig._pos = {int(k): int(v) for k, v in d["pos"].items()}
        dig._neg = {int(k): int(v) for k, v in d["neg"].items()}
        return dig


class DigestBank:
    """A named family of digests — one per fleet series (queue_wait,
    ttft, slo_margin, recovery).  Lazily creates series so callers
    never pre-negotiate the roster; merge is per-name."""

    def __init__(self, series: tuple = (),
                 alpha: float = DEFAULT_ALPHA,
                 max_buckets: int = DEFAULT_MAX_BUCKETS):
        self.alpha = alpha
        self.max_buckets = max_buckets
        self.digests: dict[str, QuantileDigest] = {
            name: QuantileDigest(alpha, max_buckets) for name in series}

    def observe(self, name: str, value: float) -> None:
        dig = self.digests.get(name)
        if dig is None:
            dig = QuantileDigest(self.alpha, self.max_buckets)
            self.digests[name] = dig
        dig.observe(value)

    def get(self, name: str) -> QuantileDigest | None:
        return self.digests.get(name)

    def merge(self, other: "DigestBank") -> None:
        for name, dig in other.digests.items():
            mine = self.digests.get(name)
            if mine is None:
                self.digests[name] = dig.copy()
            else:
                mine.merge(dig)

    @classmethod
    def merged(cls, banks) -> "DigestBank":
        banks = list(banks)
        out = cls(alpha=banks[0].alpha if banks else DEFAULT_ALPHA,
                  max_buckets=(banks[0].max_buckets if banks
                               else DEFAULT_MAX_BUCKETS))
        for b in banks:
            out.merge(b)
        return out

    def snapshot(self) -> dict:
        return {name: dig.snapshot()
                for name, dig in sorted(self.digests.items())}

    def to_json(self) -> str:
        return json.dumps(
            {name: json.loads(dig.to_json())
             for name, dig in self.digests.items()},
            sort_keys=True, separators=(",", ":"))


class NullDigestBank(DigestBank):
    """Digest-off arm of the paired observatory probe: same surface,
    zero work — so obs_digest_overhead_x measures exactly the sketch
    cost and nothing else."""

    def observe(self, name: str, value: float) -> None:
        return
