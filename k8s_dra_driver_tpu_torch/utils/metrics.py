"""Gateway metrics in the Prometheus text exposition format.

The port's copy of ``GatewayMetrics`` from
``k8s_dra_driver_tpu/utils/metrics.py``, with the helpers it uses
(``escape_label_value``, ``expo_line``, ``digest_exposition``,
``_DigestSourceMixin``), ``DriverMetrics`` (the kubelet plugin's),
``RecoveryMetrics`` (the gang supervisor's), ``FleetMetrics`` and
``render_all``.

The reference builds on ``prometheus_client``, which the card's machine
does not have, so this module carries a small registry of its own:
:class:`Counter`, :class:`Gauge` and :class:`Histogram` with
``labels(**values)``, ``inc``, ``set`` and ``observe``,
:meth:`Registry.render` and :meth:`Registry.get_sample_value`.  The
same updates render the same samples ``prometheus_client``'s
``generate_latest`` renders (``_total`` on counters; ``_bucket{le=...}``,
``_count`` and ``_sum`` on histograms, ``_sum`` left out when a bucket
bound is negative; HELP/TYPE lines; the value and label formatting),
except the ``_created`` samples, which are left out.  Updates are
thread-safe, as ``prometheus_client``'s are: the plugin's gRPC workers
and its health thread share one ``DriverMetrics``.
"""

from __future__ import annotations

import math
import threading

from .digest import DigestBank

_INF = float("inf")


def _go_float(value) -> str:
    """A sample value or bucket bound as Prometheus's Go exposition
    writes it (``prometheus_client.utils.floatToGoString``)."""
    d = float(value)
    if d == _INF:
        return "+Inf"
    if d == -_INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        # Go switches to exponents sooner than Python
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def escape_label_value(value: str) -> str:
    """Prometheus text-exposition label escaping: backslash, double
    quote, and newline are the three characters the format reserves."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _sample(name: str, labels: dict, value) -> str:
    if labels:
        lab = ",".join(f'{k}="{escape_label_value(v)}"'
                       for k, v in sorted(labels.items()))
        return f"{name}{{{lab}}} {_go_float(value)}\n"
    return f"{name} {_go_float(value)}\n"


def expo_line(name: str, labels: dict | None, value) -> str:
    """One exposition sample line with sorted, escaped labels —
    deterministic output for equal inputs (the digest summaries)."""
    v = float(value)
    if labels:
        lab = ",".join(
            f'{k}="{escape_label_value(v2)}"'
            for k, v2 in sorted(labels.items()))
        return f"{name}{{{lab}}} {v!r}\n"
    return f"{name} {v!r}\n"


class Registry:
    """Metric families in registration order; ``render()`` is the
    text exposition of all of them."""

    def __init__(self) -> None:
        self._families: list = []

    def register(self, family) -> None:
        self._families.append(family)

    def render(self) -> bytes:
        return "".join(f.render() for f in self._families).encode()

    def get_sample_value(self, name: str, labels: dict | None = None):
        """The value of the sample ``name`` with exactly ``labels``
        (``prometheus_client``'s ``CollectorRegistry.get_sample_value``):
        a counter answers by its ``_total`` name, a histogram by
        ``_bucket`` (with ``le``), ``_count`` and ``_sum``; None when no
        such sample exists (``_created`` included)."""
        want = {k: str(v) for k, v in (labels or {}).items()}
        for family in self._families:
            for sample, sample_labels, value in family.samples():
                if sample == name and sample_labels == want:
                    return value
        return None


class _Family:
    """One metric family: its children by label values (unlabelled
    families have one child, made at construction, as
    ``prometheus_client`` makes it)."""

    TYPE = ""
    #: appended to the family name on its HELP/TYPE lines
    HEADER_SUFFIX = ""

    def __init__(self, name: str, documentation: str,
                 labelnames=(), *, registry: Registry):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = self._new_child()
        registry.register(self)

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **kw):
        """The child of these label values (keyword, every label
        name), made on first use."""
        if set(kw) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(kw)} != "
                             f"{sorted(self.labelnames)}")
        key = tuple(str(kw[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def _only(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled: call labels() "
                             f"first")
        return self._children[()]

    def _header(self, name: str) -> str:
        return (f"# HELP {name} {_escape_help(self.documentation)}\n"
                f"# TYPE {name} {self.TYPE}\n")

    def _label_dicts(self):
        with self._lock:
            children = list(self._children.items())
        for key, child in children:
            yield dict(zip(self.labelnames, key)), child

    def samples(self):
        """(sample name, labels, value) in exposition order."""
        raise NotImplementedError

    def render(self) -> str:
        return self._header(self.name + self.HEADER_SUFFIX) + "".join(
            _sample(name, labels, value)
            for name, labels, value in self.samples())


class _CounterChild:
    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by "
                             "non-negative amounts")
        with self._lock:
            self.value += amount


class Counter(_Family):
    """Monotone counter; samples ``<name>_total`` (a trailing
    ``_total`` in ``name`` is not doubled)."""

    TYPE = "counter"
    HEADER_SUFFIX = "_total"

    def __init__(self, name, documentation, labelnames=(), *, registry):
        if name.endswith("_total"):
            name = name[:-len("_total")]
        super().__init__(name, documentation, labelnames,
                         registry=registry)

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1) -> None:
        self._only().inc(amount)

    def samples(self):
        for labels, c in self._label_dicts():
            yield self.name + "_total", labels, c.value


class _GaugeChild:
    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Gauge(_Family):
    TYPE = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._only().set(value)

    def samples(self):
        for labels, g in self._label_dicts():
            yield self.name, labels, g.value


class _HistogramChild:
    def __init__(self, bounds: tuple) -> None:
        self.bounds = bounds
        self.counts = [0.0] * len(bounds)
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, amount: float) -> None:
        with self._lock:
            self.sum += amount
            for i, bound in enumerate(self.bounds):
                if amount <= bound:
                    self.counts[i] += 1
                    break


class Histogram(_Family):
    """Fixed-bucket histogram; ``buckets`` sorted, ``+Inf`` appended
    when absent."""

    TYPE = "histogram"

    def __init__(self, name, documentation, labelnames=(), *, registry,
                 buckets):
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("Buckets not in sorted order")
        if not bounds or bounds[-1] != _INF:
            bounds.append(_INF)
        self.bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames,
                         registry=registry)

    def _new_child(self):
        return _HistogramChild(self.bounds)

    def observe(self, amount: float) -> None:
        self._only().observe(amount)

    def samples(self):
        for labels, h in self._label_dicts():
            acc = 0.0
            for bound, n in zip(self.bounds, h.counts):
                acc += n
                yield (f"{self.name}_bucket",
                       {**labels, "le": _go_float(bound)}, acc)
            yield f"{self.name}_count", labels, acc
            if self.bounds[0] >= 0:
                # a sum over signed observations is not a histogram sum
                # (the OpenMetrics rule prometheus_client follows)
                yield f"{self.name}_sum", labels, h.sum


#: the driver's prepare/unprepare latency ladder (seconds)
_BUCKETS = (.001, .005, .01, .05, .1, .5, 1, 5, 10, 30, 60)


class DriverMetrics:
    """The kubelet plugin's registry (plugin/driver.py,
    plugin/publisher.py, plugin/health.py): the same families, names,
    labels, buckets and HELP texts as the reference's
    ``DriverMetrics``."""

    def __init__(self):
        self.registry = Registry()
        self.prepare_seconds = Histogram(
            "tpu_dra_prepare_seconds",
            "Latency of NodePrepareResources per claim",
            ["outcome"], registry=self.registry, buckets=_BUCKETS)
        self.unprepare_seconds = Histogram(
            "tpu_dra_unprepare_seconds",
            "Latency of NodeUnprepareResources per claim",
            ["outcome"], registry=self.registry, buckets=_BUCKETS)
        self.prepared_claims = Gauge(
            "tpu_dra_prepared_claims",
            "Number of currently prepared claims", registry=self.registry)
        self.published_devices = Gauge(
            "tpu_dra_published_devices",
            "Number of devices currently published in ResourceSlices",
            registry=self.registry)
        self.unhealthy_chips = Gauge(
            "tpu_dra_unhealthy_chips",
            "Chips currently excluded from publication by the health "
            "monitor", registry=self.registry)
        self.slice_reconciles = Counter(
            "tpu_dra_resourceslice_reconciles_total",
            "ResourceSlice reconcile operations", ["op"],
            registry=self.registry)

    def render(self) -> bytes:
        return self.registry.render()


#: quantiles every digest series exposes, as (label, q) pairs —
#: Prometheus summary-type convention
_DIGEST_QUANTILES = (("0.5", 0.5), ("0.9", 0.9),
                     ("0.99", 0.99), ("0.999", 0.999))


def digest_exposition(series: tuple, groups: list) -> bytes:
    """Render digest banks as Prometheus ``summary`` families.

    ``series`` is a tuple of ``(bank_key, family_name, help_text)``;
    ``groups`` is a list of ``(labels_dict, DigestBank)``.  HELP/TYPE
    headers are emitted even when no bank holds samples yet."""
    out = []
    for key, family, help_text in series:
        out.append(f"# HELP {family} {help_text}\n")
        out.append(f"# TYPE {family} summary\n")
        for labels, bank in groups:
            dig = bank.get(key)
            if dig is None or dig.count == 0:
                continue
            for qlabel, q in _DIGEST_QUANTILES:
                out.append(expo_line(
                    family, {**labels, "quantile": qlabel},
                    dig.quantile(q)))
            out.append(expo_line(f"{family}_sum", labels, dig.total))
            out.append(expo_line(f"{family}_count", labels, dig.count))
    return "".join(out).encode()


class _DigestSourceMixin:
    """Registries that carry streaming quantile digests next to their
    fixed-bucket histograms.  Sources are ``(labels, callable ->
    DigestBank)`` — callables so render always sees the live bank."""

    DIGEST_SERIES: tuple = ()

    def _init_digest_sources(self):
        self.digest_sources: list = []

    def add_digest_source(self, source, **labels) -> None:
        """Register a live digest bank; ``labels`` (e.g. tenant) ride
        on every rendered sample from that source."""
        self.digest_sources.append(
            ({k: str(v) for k, v in labels.items()}, source))

    def _digest_groups(self) -> list:
        """Merge sources that share a label set — two gateways on one
        registry render one family, not duplicates."""
        by_labels: dict = {}
        for labels, source in self.digest_sources:
            key = tuple(sorted(labels.items()))
            bank = source()
            if key in by_labels:
                merged = DigestBank.merged([by_labels[key][1], bank])
                by_labels[key] = (labels, merged)
            else:
                by_labels[key] = (labels, bank)
        return [by_labels[k] for k in sorted(by_labels)]

    def digest_snapshot(self) -> dict:
        """JSON-safe structured view: ``{family: [{**labels, count,
        sum, min, max, p50, p90, p99, p999}, ...]}``."""
        groups = self._digest_groups()
        out: dict = {}
        for key, family, _help in self.DIGEST_SERIES:
            rows = []
            for labels, bank in groups:
                dig = bank.get(key)
                if dig is None or dig.count == 0:
                    continue
                rows.append({**labels, **dig.snapshot()})
            out[family] = rows
        return out

    def _render_digests(self) -> bytes:
        return digest_exposition(self.DIGEST_SERIES,
                                 self._digest_groups())


# Gateway latency scales are milliseconds-to-seconds (queue wait, TTFT).
_GATEWAY_BUCKETS = (.0005, .001, .005, .01, .025, .05, .1, .25, .5,
                    1, 2.5, 5, 10, 30)

# SLO margin (deadline - completion, seconds): negative = missed.
# Buckets span both signs so the histogram shows HOW badly a deadline
# was blown, not just that it was.
_SLO_MARGIN_BUCKETS = (-30.0, -5.0, -1.0, -.25, -.05, 0.0, .05, .25,
                       1.0, 5.0, 30.0)


class GatewayMetrics(_DigestSourceMixin):
    """Fleet-gateway observability (gateway/frontend.py): the same
    families, names, labels, buckets and HELP texts as the reference's
    ``GatewayMetrics``.  The histograms are the acceptance surface for
    drain/requeue: a replica kill is observable as requeued_total
    advancing and the requeued requests' queue-wait samples landing a
    second time.  Beside each latency histogram rides a streaming
    quantile digest (utils/digest.py)."""

    #: (bank key, exposition family, HELP text) for the digest
    #: summary lines render() appends after the registry exposition
    DIGEST_SERIES = (
        ("queue_wait", "tpu_gateway_digest_queue_wait_seconds",
         "Streaming quantile digest of admission-queue wait "
         "(mergeable across pumps, ~1% relative error)"),
        ("ttft", "tpu_gateway_digest_ttft_seconds",
         "Streaming quantile digest of arrival-to-first-token"),
        ("slo_margin", "tpu_gateway_digest_slo_margin_seconds",
         "Streaming quantile digest of the signed SLO margin "
         "(negative = missed)"),
    )

    def __init__(self):
        self.registry = Registry()
        self._init_digest_sources()
        reg = self.registry
        self.queue_depth = Gauge(
            "tpu_gateway_queue_depth",
            "Requests currently waiting in the admission queue",
            registry=reg)
        self.replicas = Gauge(
            "tpu_gateway_replicas", "Replicas by lifecycle state",
            ["state"], registry=reg)
        self.queue_wait_seconds = Histogram(
            "tpu_gateway_queue_wait_seconds",
            "Admission-queue wait per dispatch (requeued requests "
            "sample again on their re-dispatch)",
            registry=reg, buckets=_GATEWAY_BUCKETS)
        self.ttft_seconds = Histogram(
            "tpu_gateway_ttft_seconds",
            "Arrival to first generated token, per request",
            registry=reg, buckets=_GATEWAY_BUCKETS)
        self.slo_margin_seconds = Histogram(
            "tpu_gateway_slo_margin_seconds",
            "Deadline minus completion time per finished request "
            "(negative = SLO missed)", registry=reg,
            buckets=_SLO_MARGIN_BUCKETS)
        self.requests = Counter(
            "tpu_gateway_requests_total",
            "Terminal request outcomes "
            "(finished_attained/finished_late/shed/rejected)",
            ["outcome"], registry=reg)
        self.requeued = Counter(
            "tpu_gateway_requeued_total",
            "In-flight requests pulled back to the queue by a drain",
            registry=reg)
        self.drains = Counter(
            "tpu_gateway_drains_total",
            "Replica drains triggered by health/fault signals",
            registry=reg)
        # prefix-cache effectiveness, fleet-wide: the engines'
        # hit/miss events folded by the gateway's bus subscriber
        self.prefix_hits = Counter(
            "tpu_gateway_prefix_hits_total",
            "Prefix-cache hits across all pool engines",
            registry=reg)
        self.prefix_misses = Counter(
            "tpu_gateway_prefix_misses_total",
            "Prefix-cache misses across all pool engines",
            registry=reg)
        self.prefix_bytes_reused = Counter(
            "tpu_gateway_prefix_bytes_reused_total",
            "K/V bytes adopted from prefix caches instead of "
            "recomputed, across all pool engines",
            registry=reg)
        # disaggregated-pool KV migration (serving_disagg/): every
        # prefill->decode handoff and index fetch is one migration
        self.kv_migrations = Counter(
            "tpu_gateway_kv_migrations_total",
            "KV blocks/prefix entries moved between replicas "
            "(reshard-on-transfer)", registry=reg)
        self.kv_bytes_moved = Counter(
            "tpu_gateway_kv_bytes_moved_total",
            "Bytes of K/V cache moved between replicas",
            registry=reg)
        self.kv_migrate_seconds = Histogram(
            "tpu_gateway_kv_migrate_seconds",
            "Wall time per KV migration (gather + reshard + adopt)",
            registry=reg, buckets=_GATEWAY_BUCKETS)
        self.replica_roles = Gauge(
            "tpu_gateway_replica_role",
            "Live replicas by role (unified/prefill/decode)",
            ["role"], registry=reg)
        # paged KV-cache pressure (serving_kv/): per-replica block
        # ledger levels set once per pump step from occupancy, plus the
        # fleet-wide eviction counter folded as per-replica deltas
        self.kv_blocks_free = Gauge(
            "tpu_gateway_kv_blocks_free",
            "Free KV-cache blocks per paged replica (the router's "
            "admission headroom floor)", ["replica"],
            registry=reg)
        self.kv_blocks_used = Gauge(
            "tpu_gateway_kv_blocks_used",
            "KV-cache blocks holding live K/V per paged replica",
            ["replica"], registry=reg)
        self.kv_cow_shared = Gauge(
            "tpu_gateway_kv_cow_shared_blocks",
            "KV blocks shared copy-on-write (refcount >= 2) per "
            "paged replica — the prefix-sharing savings, in blocks",
            ["replica"], registry=reg)
        self.kv_block_evictions = Counter(
            "tpu_gateway_kv_block_evictions_total",
            "Cold prefix-store entries evicted under block pressure, "
            "across all paged replicas", registry=reg)
        self.kv_exhausted_holds = Counter(
            "tpu_gateway_kv_exhausted_holds_total",
            "Dispatch stalls where every candidate replica lacked KV "
            "block headroom for the queue head (fleet-wide block "
            "exhaustion: the request waits, then sheds at its "
            "deadline)", registry=reg)
        # tiered KV store (serving_kv/tiers.py): per-tier counters
        # delta-folded per pump step, plus the host-arena level
        self.kv_tier_hits = Counter(
            "tpu_serving_kv_tier_hits_total",
            "Prefix hits served from a demoted (host/disk) entry via "
            "promotion, across all tiered replicas",
            registry=reg)
        self.kv_tier_promotions = Counter(
            "tpu_serving_kv_tier_promotions_total",
            "Demoted KV entries promoted back into device blocks "
            "(checksum-verified device_put + adopt)",
            registry=reg)
        self.kv_tier_demotions = Counter(
            "tpu_serving_kv_tier_demotions_total",
            "Watermark evictions that demoted the entry host-ward "
            "instead of dropping it", registry=reg)
        self.kv_tier_corrupt_fallbacks = Counter(
            "tpu_serving_kv_tier_corrupt_fallbacks_total",
            "Demoted slabs that failed checksum verification at "
            "promote time — entry dropped loudly, request fell back "
            "to recompute (never a wrong answer)",
            registry=reg)
        self.kv_host_arena_bytes = Gauge(
            "tpu_serving_kv_host_arena_bytes",
            "Host-DRAM arena bytes holding demoted KV slabs per "
            "tiered replica (memwatch-accounted)", ["replica"],
            registry=reg)
        self.spec_accept_rate = Gauge(
            "tpu_gateway_spec_accept_rate",
            "EWMA of the speculative-decode draft acceptance rate "
            "per replica (accepted / proposed drafts) — the router's "
            "high-accept preference signal for SLO-tight requests",
            ["replica"], registry=reg)
        # sharded control plane: pumps serving this pool, and
        # work-stealing moves between them
        self.pumps = Gauge(
            "tpu_gateway_pumps",
            "Admission/routing pumps sharding this gateway",
            registry=reg)
        self.steals = Counter(
            "tpu_gateway_steals_total",
            "Queued requests moved between pump shards by "
            "work-stealing", registry=reg)
        # demand gauges a fleet reconciler ticks on: the arrival-rate
        # EWMA over pump steps and the signed SLO-margin EWMA
        self.arrival_rate = Gauge(
            "tpu_gateway_arrival_rate_rps",
            "EWMA of the request arrival rate (admitted + refused), "
            "updated once per pump step", registry=reg)
        self.slo_margin_ewma = Gauge(
            "tpu_gateway_slo_margin_ewma_seconds",
            "EWMA of the signed SLO margin over finished SLO-bearing "
            "requests (negative = sustained SLO pressure)",
            registry=reg)
        # per-tenant observability: tenant-tagged requests sample
        # tenant-labelled series beside the pool-wide ones
        self.tenant_queue_wait_seconds = Histogram(
            "tpu_gateway_tenant_queue_wait_seconds",
            "Admission-queue wait per dispatch, labeled by the "
            "request's tenant tag", ["tenant"],
            registry=reg, buckets=_GATEWAY_BUCKETS)
        self.tenant_requests = Counter(
            "tpu_gateway_tenant_requests_total",
            "Terminal request outcomes per tenant tag (the per-tenant "
            "SLO-attainment series: finished_attained/finished_late/"
            "shed/rejected)", ["tenant", "outcome"],
            registry=reg)
        self.tenant_slo_attained = Counter(
            "tpu_gateway_tenant_slo_attained_total",
            "SLO-bearing requests finished within deadline, per "
            "tenant tag", ["tenant"], registry=reg)
        self.tenant_slo_missed = Counter(
            "tpu_gateway_tenant_slo_missed_total",
            "SLO-bearing requests finished late or shed at deadline, "
            "per tenant tag", ["tenant"], registry=reg)
        # SLO burn-rate signal (a ``burn=`` engine of the gateway)
        self.tenant_burn_rate = Gauge(
            "tpu_gateway_tenant_burn_rate",
            "SLO error-budget burn-rate multiple per tenant over the "
            "fast/slow cycle windows (1.0 = burning exactly the "
            "budget; alert when both windows exceed their "
            "thresholds)", ["tenant", "window"],
            registry=reg)
        self.tenant_slo_alerts = Counter(
            "tpu_gateway_tenant_slo_alerts_total",
            "Burn-rate alerts fired per tenant (rising edges only: "
            "one per sustained burn episode, not one per burning "
            "cycle)", ["tenant"], registry=reg)
        # multi-adapter serving (serving_lora/): per-replica adapter
        # residency plus the fleet-wide churn counters
        self.adapter_residents = Gauge(
            "tpu_serving_adapter_residents",
            "LoRA adapters resident in the paged adapter pool per "
            "replica", ["replica"], registry=reg)
        self.adapter_pool_blocks_free = Gauge(
            "tpu_serving_adapter_pool_blocks_free",
            "Free adapter-pool slots per replica (claimable without "
            "evicting a cold adapter)", ["replica"],
            registry=reg)
        self.adapter_cold_loads = Counter(
            "tpu_serving_adapter_cold_loads_total",
            "Adapters streamed into a pool slot on a residency miss, "
            "across all replicas", registry=reg)
        self.adapter_evictions = Counter(
            "tpu_serving_adapter_evictions_total",
            "Cold resident adapters evicted under pool pressure, "
            "across all replicas", registry=reg)

    def render(self) -> bytes:
        return self.registry.render() + self._render_digests()


# Recovery wall time spans a checkpoint restore plus the first train
# step on the reformed gang: seconds to minutes, not the gateway's
# sub-second scale.
_RECOVERY_BUCKETS = (.1, .5, 1, 2.5, 5, 10, 30, 60, 120, 300, 600)


class RecoveryMetrics(_DigestSourceMixin):
    """Elastic-gang training recovery observability
    (parallel/supervisor.py): the same families, names, labels, buckets
    and HELP texts as the reference's ``RecoveryMetrics``.

    The acceptance surface for a recovery: ``restarts_total`` advances
    once per eviction→resume cycle (labeled by cause: dead / wedged /
    health, and the controlled preempt / expand / park), ``steps_lost``
    records the replay distance back to the restored checkpoint
    generation, and ``recovery_seconds`` is MTTR — eviction decision to
    the first *completed* post-resume step (scalar readback included,
    so a wedged resume can't look fast).
    """

    DIGEST_SERIES = (
        ("recovery", "tpu_train_digest_recovery_seconds",
         "Streaming quantile digest of gang MTTR (eviction decision "
         "to first completed post-resume step)"),
    )

    def __init__(self):
        self.registry = Registry()
        self._init_digest_sources()
        self.digests = DigestBank(("recovery",))
        self.add_digest_source(lambda: self.digests)
        reg = self.registry
        self.restarts = Counter(
            "tpu_train_restarts_total",
            "Gang recoveries (eviction→resume cycles) by cause",
            ["cause"], registry=reg)
        self.evicted_workers = Counter(
            "tpu_train_evicted_workers_total",
            "Gang workers evicted across all recoveries", registry=reg)
        self.steps_lost = Counter(
            "tpu_train_steps_lost_total",
            "Completed-but-uncheckpointed steps replayed after "
            "restores", registry=reg)
        self.steps_lost_last = Gauge(
            "tpu_train_steps_lost_last",
            "Steps lost in the most recent recovery", registry=reg)
        self.recovery_seconds = Histogram(
            "tpu_train_recovery_seconds",
            "Eviction decision to first completed post-resume step",
            registry=reg, buckets=_RECOVERY_BUCKETS)
        self.dp_width = Gauge(
            "tpu_train_dp_width",
            "Current data-parallel width of the supervised gang",
            registry=reg)
        self.supervisor_state = Gauge(
            "tpu_train_supervisor_state",
            "1 on the supervisor's current state, 0 elsewhere",
            ["state"], registry=reg)

    def set_state(self, state: str, all_states) -> None:
        for s in all_states:
            self.supervisor_state.labels(state=s).set(
                1.0 if s == state else 0.0)

    def observe_recovery(self, mttr_s: float) -> None:
        """One recovery sample into both views: the fixed-bucket
        histogram and the streaming digest."""
        self.recovery_seconds.observe(mttr_s)
        self.digests.observe("recovery", mttr_s)

    def render(self) -> bytes:
        return self.registry.render() + self._render_digests()


class FleetMetrics:
    """Fleet-reconciler observability (fleet/reconciler.py,
    fleet/tenancy.py): the same families, names, labels and HELP texts
    as the reference's ``FleetMetrics``.  Scale decisions are counters
    (a scale-up or drain that does not advance
    ``tpu_fleet_scale_events_total`` did not happen), the ledger is
    gauges, and the hysteresis counters are exported so an operator can
    see pressure building before the action fires."""

    def __init__(self):
        self.registry = Registry()
        self.ticks = Counter(
            "tpu_fleet_ticks_total", "Reconcile ticks executed",
            registry=self.registry)
        self.scale_events = Counter(
            "tpu_fleet_scale_events_total",
            "Actuated reconcile decisions by action "
            "(up/down/preempt/regrow)", ["action"],
            registry=self.registry)
        self.chips = Gauge(
            "tpu_fleet_chips",
            "Ledger chips by ownership class "
            "(free/serving/training/unhealthy)", ["owner"],
            registry=self.registry)
        self.pressure_ticks = Gauge(
            "tpu_fleet_pressure_ticks",
            "Consecutive pressured ticks (scale-up/preempt hysteresis "
            "counter)", registry=self.registry)
        self.calm_ticks = Gauge(
            "tpu_fleet_calm_ticks",
            "Consecutive calm ticks (scale-down/regrow hysteresis "
            "counter)", registry=self.registry)
        self.gang_dp_target = Gauge(
            "tpu_fleet_gang_dp_target",
            "dp width the reconciler most recently requested from the "
            "gang supervisor", registry=self.registry)
        # multi-tenant fleet (fleet/tenancy.py): the arbiter's actions
        # are counters, and the held-vs-entitled gauge pair is the
        # fair-share surface
        self.mt_actions = Counter(
            "tpu_fleet_mt_actions_total",
            "Multi-tenant arbiter actions by tenant and kind "
            "(grant/reclaim_park/reclaim_shrink/reclaim_drain/"
            "release/regrow/adapter_evict)", ["tenant", "action"],
            registry=self.registry)
        self.tenant_chips = Gauge(
            "tpu_fleet_tenant_chips",
            "Chips currently held per tenant (ledger ownership)",
            ["tenant"], registry=self.registry)
        self.tenant_entitled = Gauge(
            "tpu_fleet_tenant_entitled",
            "Fair-share chip entitlement per tenant (floors + "
            "priority-ordered water-fill)", ["tenant"],
            registry=self.registry)
        self.tenant_adapter_bytes = Gauge(
            "tpu_fleet_tenant_adapter_bytes",
            "Resident adapter-pool HBM per tenant across the serving "
            "workload's replicas (the adapter-quota enforcement "
            "surface)", ["tenant"], registry=self.registry)

    def render(self) -> bytes:
        return self.registry.render()


def render_all(*metrics) -> bytes:
    """One text exposition over several registries (anything with
    ``render() -> bytes``: the gateway's, the fleet's, a ``MemWatch``).
    Valid as long as no two share a metric family name, which the
    per-subsystem prefixes (tpu_gateway_/tpu_fleet_/tpu_mem_) keep so.
    This is what utils/httpendpoint.py serves on ``/metrics``."""
    return b"".join(m.render() for m in metrics)


__all__ = ["Counter", "DriverMetrics", "FleetMetrics", "Gauge", "GatewayMetrics",
           "Histogram", "RecoveryMetrics", "Registry", "digest_exposition",
           "escape_label_value", "expo_line", "render_all"]
