"""The port's autotuner (k8s_dra_driver_tpu_torch/ops/autotune.py) and its
first consumer, K7's plan picker ``pick_int8_tiles``
(k8s_dra_driver_tpu_torch/models/quant.py), against the JAX package's
ops/autotune.py.

The twins of tests/test_autotune.py (all but the flash-block picker
tests: the port's K1 takes no block sizes), then parity: the same shape
and table keys, a table saved by either package read the same by the
other; then the K7 picker: with the checked-in H100 table (no entries)
every plan is ``int8_plan``'s, a table entry sets ``k_chunk`` and
``ring``, and an entry the kernel cannot take raises naming its key.
"""

import json

import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from k8s_dra_driver_tpu.ops import autotune as jat
from k8s_dra_driver_tpu_torch.models import quant as tq
from k8s_dra_driver_tpu_torch.ops import autotune as tat
from k8s_dra_driver_tpu_torch.ops.autotune import (DEFAULT_TABLE_PATH,
                                                   Autotuner, backend_key,
                                                   get_autotuner,
                                                   reset_autotuner,
                                                   shape_key, table_key)


@pytest.fixture
def scratch_table(tmp_path, monkeypatch):
    """Point the singleton at a scratch table; restore the default."""
    path = tmp_path / "table.json"
    monkeypatch.setenv("TPU_AUTOTUNE_TABLE", str(path))
    reset_autotuner()
    yield path
    monkeypatch.delenv("TPU_AUTOTUNE_TABLE")
    reset_autotuner()


# -- twins of tests/test_autotune.py ---------------------------------------

def test_shape_key_is_canonical():
    assert shape_key(tq=2048, tk=2048, d=64, g=1, w=None) == \
        "d=64,g=1,tk=2048,tq=2048,w=0"
    assert shape_key(b=1, a=2) == shape_key(a=2, b=1)


def test_table_key_includes_dtype_and_backend():
    k1 = table_key("int8_matmul", "k=64", torch.bfloat16, "gpu-h100")
    k2 = table_key("int8_matmul", "k=64", torch.float32, "gpu-h100")
    k3 = table_key("int8_matmul", "k=64", torch.bfloat16, "cpu")
    assert len({k1, k2, k3}) == 3
    assert k1 == "int8_matmul|k=64|bfloat16|gpu-h100"


def test_pick_falls_back_to_default_and_reports_source(tmp_path):
    tuner = Autotuner(tmp_path / "none.json")
    choice = tuner.pick("int8_matmul", "k=64", torch.bfloat16,
                        default=lambda: {"k_chunk": 512}, backend="cpu")
    assert choice.source == "default"
    assert choice["k_chunk"] == 512


def test_pick_prefers_table_hit(tmp_path):
    path = tmp_path / "table.json"
    key = table_key("int8_matmul", "k=64", torch.bfloat16, "cpu")
    path.write_text(json.dumps({"entries": {
        key: {"params": {"k_chunk": 256, "ring": 3, "flag": True},
              "source": "measured"}}}))
    tuner = Autotuner(path)
    choice = tuner.pick("int8_matmul", "k=64", torch.bfloat16,
                        default={"k_chunk": 512}, backend="cpu")
    assert choice.source == "measured"
    assert choice["k_chunk"] == 256 and choice["flag"] is True
    # a hit hands back a COPY: caller mutation cannot poison the table
    choice.params["k_chunk"] = 9999
    again = tuner.pick("int8_matmul", "k=64", torch.bfloat16,
                       default={"k_chunk": 512}, backend="cpu")
    assert again["k_chunk"] == 256


def test_torn_table_falls_back_to_heuristics(tmp_path):
    path = tmp_path / "torn.json"
    path.write_text("{not json")
    tuner = Autotuner(path)
    choice = tuner.pick("k", "s", torch.float32, default={"x": 1},
                        backend="cpu")
    assert choice.source == "default" and choice["x"] == 1


def test_tune_records_best_valid_candidate(tmp_path):
    tuner = Autotuner(tmp_path / "t.json")
    timings = {(256,): (0.002, True), (512,): (0.001, True),
               (1024,): (0.0005, False)}      # fastest is INVALID

    def measure(params):
        return timings[(params["bq"],)]

    best = tuner.tune("k", "s", torch.bfloat16,
                      [{"bq": 256}, {"bq": 512}, {"bq": 1024}],
                      measure, backend="cpu")
    assert best == {"bq": 512}                # best VALID wins
    entry = tuner.table[table_key("k", "s", torch.bfloat16, "cpu")]
    assert entry["valid"] is True
    assert len(entry["runs"]) == 3            # every run auditable
    assert tuner.pick("k", "s", torch.bfloat16, default={},
                      backend="cpu")["bq"] == 512


def test_tune_survives_erroring_candidate(tmp_path):
    tuner = Autotuner(tmp_path / "t.json")

    def measure(params):
        if params["bq"] == 256:
            raise RuntimeError("plan refused")
        return 0.001, True

    best = tuner.tune("k", "s", torch.bfloat16,
                      [{"bq": 256}, {"bq": 512}], measure, backend="cpu")
    assert best == {"bq": 512}
    runs = tuner.table[table_key("k", "s", torch.bfloat16, "cpu")]["runs"]
    assert any("error" in r for r in runs)


def test_tune_all_invalid_is_recorded_not_promoted(tmp_path):
    tuner = Autotuner(tmp_path / "t.json")
    best = tuner.tune("k", "s", torch.bfloat16,
                      [{"bq": 256}, {"bq": 512}],
                      lambda p: (0.001 * p["bq"], False), backend="cpu")
    assert best == {"bq": 256}                # fastest of the invalid
    entry = tuner.table[table_key("k", "s", torch.bfloat16, "cpu")]
    assert entry["valid"] is False


def test_save_load_roundtrip(tmp_path):
    tuner = Autotuner(tmp_path / "t.json")
    tuner.tune("k", "s", torch.bfloat16, [{"bq": 512}],
               lambda p: (0.001, True), backend="cpu")
    path = tuner.save()
    again = Autotuner(path)
    assert again.lookup("k", "s", torch.bfloat16,
                        backend="cpu") == {"bq": 512}


def test_singleton_honors_env_override(scratch_table):
    key = table_key("k", "s", torch.bfloat16, "cpu")
    scratch_table.write_text(json.dumps({"entries": {
        key: {"params": {"bq": 64}, "source": "measured"}}}))
    assert get_autotuner().lookup("k", "s", torch.bfloat16,
                                  backend="cpu") == {"bq": 64}


def test_backend_key_is_cpu_on_this_suite():
    assert backend_key() == "cpu"


def test_checked_in_h100_table_parses_with_no_entries():
    """The port's committed table: its own file (the JAX package's v5e
    table is never read), it parses, and it holds no entries, so every
    kernel runs its heuristic plan; the singleton reads it by default."""
    assert DEFAULT_TABLE_PATH.name == "autotune_h100.json"
    assert DEFAULT_TABLE_PATH != jat.DEFAULT_TABLE_PATH
    data = json.loads(DEFAULT_TABLE_PATH.read_text())
    assert data["entries"] == {}
    reset_autotuner()
    try:
        tuner = get_autotuner()
        assert tuner.path == DEFAULT_TABLE_PATH
        assert tuner.pick("int8_matmul", "g=1,k=1024,m=8,n=32000",
                          torch.bfloat16, default={"x": 1}).source \
            == "default"
    finally:
        reset_autotuner()


# -- parity with the JAX package -------------------------------------------

@pytest.mark.parametrize("dims", [
    dict(tq=2048, tk=2048, d=64, g=1, w=None),
    dict(g=16, m=8, k=512, n=4096), dict(m=1, k=1024, n=32000)])
def test_shape_keys_equal_jax(dims):
    assert shape_key(**dims) == jat.shape_key(**dims)


@pytest.mark.parametrize("tdt,jdt", [(torch.bfloat16, jnp.bfloat16),
                                     (torch.float32, jnp.float32),
                                     (torch.float16, jnp.float16),
                                     ("float32", "float32")])
def test_table_keys_equal_jax(tdt, jdt):
    for backend in ("cpu", "gpu-nvidia-h100-80gb-hbm3"):
        assert table_key("int8_matmul", "k=64", tdt, backend) == \
            jat.table_key("int8_matmul", "k=64", jdt, backend)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_saved_table_reads_the_same_in_both(tmp_path, writer):
    """A table tuned and saved by either package's Autotuner: both read
    the same entry for the same key, the other package's dtype
    included."""
    mod, dt = ((tat, torch.bfloat16) if writer == "torch"
               else (jat, jnp.bfloat16))
    tuner = mod.Autotuner(tmp_path / "t.json")
    tuner.tune("int8_bmm", "g=16,k=512,m=8,n=4096", dt,
               [{"k_chunk": 256, "ring": 2}, {"k_chunk": 512, "ring": 2}],
               lambda p: (p["k_chunk"] * 1e-6, True), backend="cpu")
    path = tuner.save()
    doc = json.loads(path.read_text())
    assert list(doc["entries"]) == [
        "int8_bmm|g=16,k=512,m=8,n=4096|bfloat16|cpu"]
    got_t = Autotuner(path).lookup("int8_bmm", "g=16,k=512,m=8,n=4096",
                                   torch.bfloat16, backend="cpu")
    got_j = jat.Autotuner(path).lookup("int8_bmm", "g=16,k=512,m=8,n=4096",
                                       jnp.bfloat16, backend="cpu")
    assert got_t == got_j == {"k_chunk": 256, "ring": 2}


def test_torn_table_falls_back_in_both(tmp_path):
    path = tmp_path / "torn.json"
    path.write_text('{"entries": {')
    for mod, dt in ((jat, jnp.float32), (tat, torch.float32)):
        assert mod.Autotuner(path).pick("k", "s", dt, default={"x": 2},
                                        backend="cpu").source == "default"


# -- K7's plan through the autotuner ---------------------------------------

def _k7_shapes():
    out = []
    for kind, m, k, n, label in chip_smoke.int8_cases():
        g = 16 if kind == "K7b" else 1
        for dtype in (torch.bfloat16, torch.float32):
            out.append(pytest.param(g, m, k, n, dtype, kind == "K7b",
                                    id=f"{kind}-{m}x{k}x{n}-{label}-"
                                       f"{str(dtype)[6:]}"))
    return out


@pytest.mark.parametrize("g,m,k,n,dtype,batched", _k7_shapes())
def test_pick_int8_tiles_default_is_int8_plan(g, m, k, n, dtype, batched):
    """With the checked-in (empty) table every K7 launch keeps
    ``int8_plan``'s plan, on every shape the card checks."""
    reset_autotuner()
    try:
        assert tq.pick_int8_tiles(g, m, k, n, dtype, batched=batched) == \
            tq.int8_plan(g, m, k, n, dtype)
    finally:
        reset_autotuner()


def _entry(path, kernel, key, dtype, params):
    path.write_text(json.dumps({"entries": {
        table_key(kernel, key, dtype, "cpu"): {"params": params,
                                               "source": "measured"}}}))


def test_table_entry_sets_k_chunk_and_ring(scratch_table):
    key = shape_key(g=1, m=8, k=1024, n=32000)
    _entry(scratch_table, "int8_matmul", key, torch.bfloat16,
           {"k_chunk": 256, "ring": 2})
    plan = tq.pick_int8_tiles(1, 8, 1024, 32000, torch.bfloat16)
    assert plan == tq.Int8Plan(16, 128, 4, 256, 250 * 4, 2)
    # the same shape batched, or in f32, is another key: the heuristic
    assert tq.pick_int8_tiles(1, 8, 1024, 32000, torch.bfloat16,
                              batched=True) == \
        tq.int8_plan(1, 8, 1024, 32000, torch.bfloat16)
    assert tq.pick_int8_tiles(1, 8, 1024, 32000, torch.float32) == \
        tq.int8_plan(1, 8, 1024, 32000, torch.float32)


def test_batched_entry_and_ragged_last_chunk(scratch_table):
    key = shape_key(g=16, m=8, k=512, n=4096)
    _entry(scratch_table, "int8_bmm", key, torch.float32,
           {"k_chunk": 192, "ring": 2})
    plan = tq.pick_int8_tiles(16, 8, 512, 4096, torch.float32,
                              batched=True)
    assert (plan.splits, plan.k_chunk, plan.ring) == (3, 192, 2)
    assert plan.m_tile == 4 and plan.blocks == 16 * 2 * 32 * 3


def test_pick_is_cached_per_shape_on_the_table(scratch_table):
    calls = []
    tuner = get_autotuner()
    real = tuner.pick

    def counting(*a, **kw):
        calls.append(a[:2])
        return real(*a, **kw)

    tuner.pick = counting
    for _ in range(3):
        tq.pick_int8_tiles(1, 8, 1024, 32000, torch.bfloat16)
    tq.pick_int8_tiles(1, 1, 1024, 32000, torch.bfloat16)
    assert len(calls) == 2
    assert tuner.picks == {"measured": 0, "default": 2}
    # a tune changes the table and empties the cache
    tuner.tune("int8_matmul", shape_key(g=1, m=8, k=1024, n=32000),
               torch.bfloat16, [{"k_chunk": 512, "ring": 3}],
               lambda p: (1e-5, True), backend="cpu")
    plan = tq.pick_int8_tiles(1, 8, 1024, 32000, torch.bfloat16)
    assert (plan.k_chunk, plan.ring, plan.splits) == (512, 3, 2)
    assert len(calls) == 3
    assert tuner.picks == {"measured": 1, "default": 2}


@pytest.mark.parametrize("params,dtype,match", [
    ({"k_chunk": 100, "ring": 2}, torch.bfloat16, "multiple of 64"),
    ({"k_chunk": 0, "ring": 2}, torch.bfloat16, "multiple of 64"),
    ({"k_chunk": 256, "ring": 3}, torch.float32, "ring 3"),
    ({"k_chunk": 256, "ring": 4}, torch.bfloat16, "ring 4"),
    ({"k_chunk": 64, "ring": 2}, torch.float32, "65535"),
    ({"ring": 2}, torch.bfloat16, "k_chunk and ring"),
])
def test_entry_the_kernel_cannot_take_raises_naming_its_key(
        scratch_table, params, dtype, match):
    g, m, k, n = (4096, 1, 1024, 128) if match == "65535" else \
        (16, 8, 512, 4096)
    key = shape_key(g=g, m=m, k=k, n=n)
    _entry(scratch_table, "int8_bmm", key, dtype, params)
    with pytest.raises(ValueError, match=match) as err:
        tq.pick_int8_tiles(g, m, k, n, dtype, batched=True)
    assert table_key("int8_bmm", key, dtype, "cpu") in str(err.value)


def test_int8_wrappers_on_the_cpu_ignore_the_table(scratch_table):
    """On CPU tensors K7's wrappers take the plain version and never
    consult a plan: a table entry the kernel would refuse changes
    nothing there."""
    _entry(scratch_table, "int8_matmul", shape_key(g=1, m=2, k=64, n=8),
           torch.float32, {"k_chunk": 3, "ring": 9})
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, generator=gen)
    w = torch.randn(64, 8, generator=gen)
    qt = tq.quantize_for("btd,dv->btv", w)
    got = tq.int8_matmul(x, qt.q, qt.scale.reshape(8))
    assert torch.equal(got, tq.int8_matmul_reference(
        x, qt.q, qt.scale.reshape(8)))


@pytest.mark.parametrize("k_chunk,ring,match", [
    (100, None, "multiple of 64"), (None, 3, "ring 3"),
    (64, 2, "65535")])
def test_explicit_plan_is_checked_before_any_launch(monkeypatch, k_chunk,
                                                    ring, match):
    """An explicit plan (the tuner's candidates) goes through the same
    checks as a table entry, before the kernel library is touched."""
    called = []
    monkeypatch.setattr(tq._build, "library",
                        lambda: called.append(1) or None)
    g, k = (4096, 1024) if match == "65535" else (16, 512)
    x = torch.empty((g, 8, k), dtype=torch.float32, device="meta")
    q = torch.empty((g, k, 128), dtype=torch.int8, device="meta")
    s = torch.empty((g, 128), dtype=torch.float32, device="meta")
    out = torch.empty((g, 8, 128), dtype=torch.float32, device="meta")
    reset_autotuner()
    try:
        with pytest.raises(ValueError, match=match) as err:
            tq._launch(x, q, s, out, "int8_bmm", k_chunk, ring)
    finally:
        reset_autotuner()
    assert "int8_bmm explicit plan" in str(err.value)
    assert not called
