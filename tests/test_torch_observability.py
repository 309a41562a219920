"""Port serving observability (k8s_dra_driver_tpu_torch/utils/tracing.py's
analysis and exporter, utils/metrics.py ``Registry.get_sample_value``,
gateway/burnrate.py, utils/memwatch.py, gateway/obsprobe.py,
serving_kv/probe.py) against the JAX package, on the CPU in f32.

The same spans, the same seeded observe/step scripts, the same ledgers
and the same probe arguments go through the JAX functions and their
port counterparts: critical paths and burn-rate alerts must be equal,
Chrome-trace exports and ``MemWatch`` renders byte-equal, probe counts
equal.  ``MemWatch`` on a port engine counts tensor bytes only: a
cache's ``pos`` is a Python int in the port and a 4-byte int32 leaf in
JAX (ROADMAP Queue C item 16), pinned here.  On the card
``chip_smoke.py`` holds the ledger against ``torch.cuda.memory_stats``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client import CollectorRegistry
from prometheus_client import Counter as PCounter
from prometheus_client import Gauge as PGauge
from prometheus_client import Histogram as PHistogram

import bench
from k8s_dra_driver_tpu.cluster import bus as jbus
from k8s_dra_driver_tpu.gateway import burnrate as jburn
from k8s_dra_driver_tpu.gateway.obsprobe import (
    observatory_probe as j_observatory_probe)
from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.serving_kv.probe import (
    paged_kv_probe as j_paged_kv_probe)
from k8s_dra_driver_tpu.serving_lora import pool as jl
from k8s_dra_driver_tpu.utils import memwatch as jmw
from k8s_dra_driver_tpu.utils import metrics as jmet
from k8s_dra_driver_tpu.utils import tracing as jtr
from k8s_dra_driver_tpu_torch import gateway as tg
from k8s_dra_driver_tpu_torch.cluster import bus as tbus
from k8s_dra_driver_tpu_torch.gateway import burnrate as tburn
from k8s_dra_driver_tpu_torch.gateway.obsprobe import observatory_probe
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.serving_kv.probe import paged_kv_probe
from k8s_dra_driver_tpu_torch.serving_lora import (AdapterManifest,
                                                   AdapterPool,
                                                   make_adapter)
from k8s_dra_driver_tpu_torch.utils import memwatch as tmw
from k8s_dra_driver_tpu_torch.utils import metrics as tmet
from k8s_dra_driver_tpu_torch.utils import tracing as ttr

pytestmark = pytest.mark.timeout_s(180)

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)

#: bytes of the int32 ``pos`` leaf a JAX KVCache carries and the port's
#: cache keeps as a Python int (ROADMAP Queue C item 16)
POS_BYTES = 4


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, device="cpu")


def prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], n).astype(np.int32)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# -- tracing: critical path and the Chrome-trace exporter -------------------

def critical_spans(mod):
    """tests/test_tracing.py's critical-path fixture on ``mod``'s
    Tracer."""
    tr = mod.Tracer()
    ctx = tr.begin("u")
    tr.emit(ctx, "dispatch", 0.0, 2.0, route_s=0.5)
    tr.emit(ctx, "prefill", 2.0, 3.0)
    tr.emit(ctx, "migrate", 3.0, 3.5)
    tr.emit(ctx, "terminal", 3.5, 7.5, tokens=4)
    tr.emit(ctx, "drain_gap", 8.0, 9.0, route_s=0.25)
    other = tr.begin("v")
    tr.emit(other, "dispatch", 0.0, 100.0)
    return list(tr.spans)


def chrome_spans(mod):
    """tests/test_tracing.py's Chrome-trace fixture, plus an instant
    span, a trace-named track and a sub-microsecond duration."""
    tr = mod.Tracer()
    ctx = tr.begin("u", tenant="acme")
    tr.emit(ctx, "dispatch", 1.5, 2.0, track="r0", depth=2)
    tr.emit(ctx, "terminal", 2.0, 2.25, track="r1")
    tr.emit(ctx, "alert", 2.5, track="gateway", burn_fast=3.125)
    tr.emit(tr.begin("w"), "prefill", 0.1234567, 0.1234571)
    return list(tr.spans)


@pytest.mark.parametrize("trace_id", ["t-u", "t-v", "t-missing"])
def test_critical_path_equals_jax(trace_id):
    got = ttr.critical_path(critical_spans(ttr), trace_id)
    want = jtr.critical_path(critical_spans(jtr), trace_id)
    assert got == want
    if trace_id == "t-u":
        assert got["route"] == 0.75 and got["total"] == 9.0
        assert got["decode_per_token"] == 1.0 and got["spans"] == 5


@pytest.mark.parametrize("fixture", [critical_spans, chrome_spans])
def test_export_chrome_byte_equal_jax(fixture):
    spans = fixture(ttr)
    assert spans == fixture(jtr)
    got = ttr.export_chrome(spans)
    assert got == jtr.export_chrome(spans)
    assert got == ttr.export_chrome(spans)          # deterministic
    assert ttr.chrome_trace(spans) == jtr.chrome_trace(spans)


# -- Registry.get_sample_value: prometheus_client's answers -----------------

def sample_script(Counter, Gauge, Histogram, registry):
    c = Counter("reqs_total", "requests", ["outcome"], registry=registry)
    c.labels(outcome="ok").inc()
    c.labels(outcome="ok").inc(2.5)
    c.labels(outcome="shed").inc()
    plain = Counter("ticks", "ticks", registry=registry)
    plain.inc(3)
    g = Gauge("depth", "queue depth", registry=registry)
    g.set(7)
    lg = Gauge("chips", "chips", ["owner"], registry=registry)
    lg.labels(owner="free").set(2)
    h = Histogram("wait_seconds", "wait", registry=registry,
                  buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 20.0):
        h.observe(v)
    s = Histogram("margin_seconds", "margin", ["tenant"],
                  registry=registry, buckets=(-1.0, 0.0, 1.0))
    s.labels(tenant="a").observe(-2.0)
    s.labels(tenant="a").observe(0.5)


SAMPLE_QUERIES = [
    ("reqs_total", {"outcome": "ok"}),
    ("reqs_total", {"outcome": "shed"}),
    ("reqs_total", {"outcome": "never"}),
    ("reqs_total", None),
    ("reqs", {"outcome": "ok"}),
    ("ticks_total", None),
    ("ticks", None),
    ("depth", None),
    ("depth", {"x": "y"}),
    ("chips", {"owner": "free"}),
    ("chips", {"owner": "serving"}),
    ("wait_seconds_count", None),
    ("wait_seconds_sum", None),
    ("wait_seconds_bucket", {"le": "1.0"}),
    ("wait_seconds_bucket", {"le": "+Inf"}),
    ("wait_seconds_bucket", {"le": "1"}),
    ("wait_seconds", None),
    ("margin_seconds_count", {"tenant": "a"}),
    ("margin_seconds_sum", {"tenant": "a"}),
    ("margin_seconds_bucket", {"tenant": "a", "le": "-1.0"}),
    ("margin_seconds_bucket", {"tenant": "a", "le": "0.0"}),
    ("absent", None),
]


@pytest.mark.parametrize("name,labels", SAMPLE_QUERIES)
def test_get_sample_value_answers_as_prometheus_client(name, labels):
    ref = CollectorRegistry()
    sample_script(PCounter, PGauge, PHistogram, ref)
    ours = tmet.Registry()
    sample_script(tmet.Counter, tmet.Gauge, tmet.Histogram, ours)
    assert ours.get_sample_value(name, labels) == \
        ref.get_sample_value(name, labels)


def test_get_sample_value_has_no_created_samples():
    """Queue C item 14: prometheus_client answers ``_created``, the
    port's registry renders none and answers None."""
    ref = CollectorRegistry()
    sample_script(PCounter, PGauge, PHistogram, ref)
    ours = tmet.Registry()
    sample_script(tmet.Counter, tmet.Gauge, tmet.Histogram, ours)
    assert ref.get_sample_value("ticks_created") is not None
    assert ours.get_sample_value("ticks_created") is None


def test_render_all_joins_registries():
    g, f = tmet.GatewayMetrics(), tmet.FleetMetrics()
    assert tmet.render_all(g, f) == g.render() + f.render()


# -- SloBurnEngine: seeded observe/step scripts -----------------------------

BURN_PARAMS = [
    {},
    dict(slo_target=0.99, fast_window=4, slow_window=16,
         fast_threshold=14.4, slow_threshold=6.0, min_samples=1),
    dict(slo_target=0.5, fast_window=1, slow_window=1,
         fast_threshold=1.0, slow_threshold=1.0, min_samples=3),
    dict(slo_target=0.9, fast_window=8, slow_window=8,
         fast_threshold=2.0, slow_threshold=2.0, min_samples=5),
]


def burn_run(pkg, kw, seed, cycles=90):
    """Three tenants over ``cycles`` cycles: a calm stretch, a burn for
    tenant b (then a), calm again.  Returns everything the engine
    produced: fired alerts per cycle, alerts_total, the active set, the
    gateway metric samples, the bus journal and the alert spans."""
    burn_mod, bus_mod, met_mod, tr_mod = pkg
    clock = Clock()
    bus = bus_mod.EventBus(seed=0)
    tracer = tr_mod.Tracer(bus=bus, clock=clock)
    metrics = met_mod.GatewayMetrics()
    eng = burn_mod.SloBurnEngine(metrics=metrics, bus=bus,
                                 tracer=tracer, clock=clock, **kw)
    rng = np.random.default_rng(seed)
    fired = []
    for cycle in range(cycles):
        clock.t = 0.5 * cycle
        for tenant in ("a", "b", "c"):
            p_miss = 0.05
            if 20 <= cycle < 45 and tenant == "b":
                p_miss = 0.8
            if 50 <= cycle < 60 and tenant == "a":
                p_miss = 0.5
            for _ in range(int(rng.integers(0, 4))):
                eng.observe(tenant, bool(rng.random() >= p_miss))
        fired.append(eng.step())
        tracer.flush()
        bus.pump()
    samples = [ln for ln in metrics.render().decode().splitlines()
               if "_created" not in ln]
    journal = [(e["topic"], e["payload"]) for e in bus.journal_dump()]
    return dict(fired=fired, alerts_total=eng.alerts_total,
                active=sorted(eng.active), cycle=eng.cycle,
                samples=samples, journal=journal,
                spans=list(tracer.spans))


@pytest.mark.parametrize("kw", BURN_PARAMS,
                         ids=["default", "tight", "one_cycle", "flat"])
@pytest.mark.parametrize("seed", [0, 1])
def test_burn_engine_equals_jax(kw, seed):
    got = burn_run((tburn, tbus, tmet, ttr), kw, seed)
    want = burn_run((jburn, jbus, jmet, jtr), kw, seed)
    assert got == want
    assert any(got["fired"]) or kw.get("fast_threshold", 2.0) > 10


def test_burn_engine_refuses_bad_windows_as_jax():
    for kw in (dict(slo_target=1.0), dict(fast_window=0),
               dict(fast_window=9, slow_window=8)):
        with pytest.raises(ValueError) as got:
            tburn.SloBurnEngine(**kw)
        with pytest.raises(ValueError) as want:
            jburn.SloBurnEngine(**kw)
        assert str(got.value) == str(want.value)


def test_burn_engine_attaches_to_the_port_gateway():
    """A bare engine adopts the gateway's metrics, bus, tracer and
    clock; the gateway steps it once a cycle and feeds it terminals."""
    clock = Clock()
    bus = tbus.EventBus(seed=0)
    tracer = ttr.Tracer(bus=bus, clock=clock)
    eng = tburn.SloBurnEngine(min_samples=1, fast_window=1,
                              slow_window=1)
    mgr = tg.ReplicaManager(lambda name: tg.NullEngine(slots=2),
                            replicas=1)
    gw = tg.FleetGateway(mgr, queue_capacity=16, clock=clock, bus=bus,
                         tracer=tracer, burn=eng, tenant="t")
    assert (eng.metrics, eng.bus, eng.tracer, eng.clock) == \
        (gw.metrics, bus, tracer, clock)
    for i in range(4):
        gw.submit(ts.Request(uid=f"u{i}", prompt=prompt(i, 4),
                             max_new=1), slo_s=0.5)
    clock.t = 10.0      # every deadline already past: all miss
    gw.run_until_idle()
    assert eng.cycle == gw.stats()["steps"]
    assert eng.alerts_total == 1
    assert gw.metrics.registry.get_sample_value(
        "tpu_gateway_tenant_slo_alerts_total", {"tenant": "t"}) == 1


# -- MemWatch -----------------------------------------------------------------

def jax_pool(n_resident, names):
    pool = jl.AdapterPool(JCFG, 2, n_resident=n_resident)
    for n in names:
        pool.register(jl.AdapterManifest(
            n, 2, source=jl.make_adapter(JCFG, 2, seed=7, scale=0.5)))
    return pool


def port_pool(n_resident, names):
    pool = AdapterPool(TCFG, 2, n_resident=n_resident, device="cpu")
    for n in names:
        pool.register(AdapterManifest(
            n, 2, source=make_adapter(TCFG, 2, seed=7, scale=0.5)))
    return pool


#: engine cases after tests/test_serving_kv.py:1118 (tiered) and
#: tests/test_health.py:292: (engine kwargs, whether a warm request
#: runs first, the bytes a JAX component holds beyond the port's)
ENGINE_CASES = {
    "paged": (dict(kv_layout="paged", kv_blocks=16), False,
              {"paged_kv_pool": POS_BYTES}),
    "contiguous_prefix": (dict(prefix_cache=2), True,
                          {"prefix_cache": POS_BYTES}),
    "tiered": (dict(kv_layout="paged", kv_blocks=16,
                    kv_host_bytes=1 << 20), True,
               {"paged_kv_pool": POS_BYTES}),
    "adapters": (dict(kv_layout="paged", kv_blocks=16, adapters=3),
                 False, {"paged_kv_pool": POS_BYTES}),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_account_engine_equals_jax(params, case):
    kw, warm, pos_extra = ENGINE_CASES[case]
    kw = dict(kw)
    n_adapters = kw.pop("adapters", 0)
    names = [f"a{i}" for i in range(n_adapters)]
    jkw, tkw = dict(kw), dict(kw)
    if n_adapters:
        jkw["adapter_pool"] = jax_pool(2, names)
        tkw["adapter_pool"] = port_pool(2, names)
    jeng = js.ServingEngine(params[0], JCFG, slots=2, **jkw)
    teng = ts.ServingEngine(params[1], TCFG, slots=2, device="cpu", **tkw)
    if warm:
        for eng, mod in ((jeng, js), (teng, ts)):
            eng.submit(mod.Request(uid="warm", prompt=prompt(99, 21),
                                   max_new=1))
            eng.run()
            if "kv_host_bytes" in kw:
                eng._prefix.flush()
    jw, tw = jmw.MemWatch(), tmw.MemWatch(device="cpu")
    want_total = jw.account_engine(jeng, "r0")
    got_total = tw.account_engine(teng, "r0")
    want = jw.snapshot()["components"]
    got = tw.snapshot()["components"]
    assert sorted(got) == sorted(want)
    for key, n in want.items():
        comp = key.split("/")[0]
        assert got[key] == n - pos_extra.get(comp, 0), key
    assert got_total == want_total - sum(pos_extra.values())
    if case == "tiered":
        assert got["kv_host_arena/r0"] == \
            teng._prefix.host_arena_bytes() > 0
    if case == "adapters":
        assert got["adapter_pool/r0"] == \
            tkw["adapter_pool"].accounted_bytes() > 0
    # the paged pool is its tensors' bytes, exactly
    if getattr(teng, "pool", None) is not None:
        assert got["paged_kv_pool/r0"] == sum(
            t.numel() * t.element_size() for t in teng.pool.tensors())


def ledger_script(mw, tmp_path):
    mw.account("model_params", 1024, unit='we"ird\\x\ny')
    mw.account("paged_kv_pool", 65536, unit="r0")
    mw.account("adapter_pool", 3 * 512, unit="r1")
    mw.account("opt_state", -5, unit="gang0")
    (tmp_path / "sub").mkdir(exist_ok=True)
    (tmp_path / "a.bin").write_bytes(b"x" * 100)
    (tmp_path / "sub" / "b.bin").write_bytes(b"y" * 23)
    mw.account_compile_cache(tmp_path)
    mw.account("gone", 7, unit="r9")
    mw.forget("r9")


def test_memwatch_render_byte_equal_jax(tmp_path):
    got, want = tmw.MemWatch(device="cpu"), jmw.MemWatch()
    ledger_script(got, tmp_path)
    ledger_script(want, tmp_path)
    assert got.device_bytes_in_use() == want.device_bytes_in_use()
    assert got.device_bytes_in_use()[1] == "ledger"
    assert got.render() == want.render()
    assert got.snapshot() == want.snapshot()
    fresh = tmw.MemWatch(device="cpu").render()
    assert fresh == jmw.MemWatch().render()


def test_memwatch_defaults_to_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmw.MemWatch()


def test_tree_nbytes_walks_the_port_structures(params):
    eng = ts.ServingEngine(params[1], TCFG, slots=2, kv_layout="paged",
                           kv_blocks=16, device="cpu")
    want = sum(t.numel() * t.element_size() for t in eng.pool.tensors())
    assert tmw.tree_nbytes(eng.pool) == want
    assert tmw.tree_nbytes({"a": [np.zeros(3, np.int32), None, 5],
                            "b": (torch.zeros(2, 2, dtype=torch.bfloat16),)}
                           ) == 12 + 8
    assert tmw.tree_nbytes(params[1]) == jmw.tree_nbytes(params[0])


def test_gateway_feeds_memwatch_and_forgets_retired_units(params):
    """The port gateway accounts every live replica's engine each step,
    as the JAX gateway does, and drops a retired replica's cells at the
    next step, which the JAX gateway does not (ROADMAP Queue C item
    18)."""
    units = {}
    for side, (gw_mod, srv, mw, p, cfg, kw) in {
            "jax": (__import__("k8s_dra_driver_tpu.gateway",
                               fromlist=["x"]), js, jmw.MemWatch(),
                    params[0], JCFG, {}),
            "torch": (tg, ts, tmw.MemWatch(device="cpu"), params[1],
                      TCFG, {"device": "cpu"})}.items():
        mgr = gw_mod.ReplicaManager(
            lambda name: srv.ServingEngine(p, cfg, slots=2,
                                           kv_layout="paged",
                                           kv_blocks=16, **kw),
            replicas=2)
        gw = gw_mod.FleetGateway(mgr, queue_capacity=8, memwatch=mw)
        gw.submit(srv.Request(uid="x", prompt=prompt(3, 6), max_new=2))
        gw.run_until_idle()
        before = sorted(mw.snapshot()["components"])
        mgr.retire(mgr.replicas[0])
        gw.step()
        units[side] = (before, sorted(mw.snapshot()["components"]))
    both = ["model_params/r0", "model_params/r1", "paged_kv_pool/r0",
            "paged_kv_pool/r1"]
    assert units["torch"][0] == units["jax"][0] == both
    assert units["jax"][1] == both
    assert units["torch"][1] == ["model_params/r1", "paged_kv_pool/r1"]


# -- the probes -------------------------------------------------------------

@pytest.fixture(scope="module")
def obs_probes():
    return (observatory_probe(**bench.TINY_OBS_KWARGS, device="cpu"),
            j_observatory_probe(**bench.TINY_OBS_KWARGS))


@pytest.mark.parametrize("key", ["n_requests", "reps", "pumps",
                                 "replicas", "slots", "valid",
                                 "merged_digest_count",
                                 "hbm_device_source"])
def test_observatory_probe_counts_equal_jax(obs_probes, key):
    got, want = obs_probes
    assert got[key] == want[key]


def test_observatory_probe_components_equal_jax(obs_probes):
    got, want = obs_probes
    n = bench.TINY_OBS_KWARGS["n_requests"]
    assert got["valid"] is True and got["merged_digest_count"] == n
    assert sum(got["per_pump_counts"]) == n
    assert sorted(got["hbm_components"]) == sorted(want["hbm_components"])
    assert got["hbm_accounted_frac"] == want["hbm_accounted_frac"] == 1.0
    assert got["merged_quantiles"]["p99"] is not None
    assert got["digest_overhead_x"] > 0
    for key in ("model_params/r0", "opt_state/gang0"):
        assert got["hbm_components"][key] == want["hbm_components"][key]
    assert got["hbm_components"]["paged_kv_pool/r0"] == \
        want["hbm_components"]["paged_kv_pool/r0"] - POS_BYTES
    assert set(got) == set(want)


@pytest.fixture(scope="module")
def kv_probes():
    return (paged_kv_probe(wave=4, repeats=1, device="cpu"),
            j_paged_kv_probe(wave=4, repeats=1))


@pytest.mark.parametrize("key", ["pg_max_concurrent_x",
                                 "pg_cow_shared_frac",
                                 "paged_peak_active",
                                 "contig_peak_active", "budget_rows",
                                 "alloc_failures", "byte_equal"])
def test_paged_kv_probe_equals_jax(kv_probes, key):
    got, want = kv_probes
    assert got[key] == want[key]
    assert set(got) == set(want)
    assert got["byte_equal"] is True and got["pg_cow_shared_frac"] > 0
