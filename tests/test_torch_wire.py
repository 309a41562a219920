"""Port wire layer of the multi-process gateway against the JAX package's,
on the CPU: the frame codecs (k8s_dra_driver_tpu_torch/gateway/wire.py),
the KV-over-the-wire codec (serving_disagg/wirekv.py), and the small
pieces the pump processes lean on (cluster/bus.py ``BusTap``,
utils/backoff.py, cluster/faults.py's plan, coordclient/client.py's
membership files).

Frames are byte-equal to JAX's for every dtype numpy names and decode
in either package.  bfloat16 is the deliberate divergence: the port
ships a bf16 tensor's raw 16-bit patterns under the tag ``"bfloat16"``
and decodes it bit for bit; JAX tags an ``ml_dtypes`` bfloat16 array
``"<V2"``, which decodes to a void array JAX itself refuses (pinned
here).  A JAX f32 block encoded by JAX decodes in the port to
``kv_from_jax`` of the block, the port's frame of that block equals
JAX's key for key, and the adopted stream equals JAX's.
"""

import io
import json
import os
import random
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.cluster import bus as jbus
from k8s_dra_driver_tpu.cluster import faults as jfaults
from k8s_dra_driver_tpu.coordclient import client as jcoord
from k8s_dra_driver_tpu.gateway import admission as jadm
from k8s_dra_driver_tpu.gateway import procpump as jpp
from k8s_dra_driver_tpu.gateway import wire as jw
from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.serving_disagg import wirekv as jkv
from k8s_dra_driver_tpu.utils import backoff as jbackoff
from k8s_dra_driver_tpu_torch.cluster import bus as tbus
from k8s_dra_driver_tpu_torch.cluster import faults as tfaults
from k8s_dra_driver_tpu_torch.coordclient import client as tcoord
from k8s_dra_driver_tpu_torch.gateway import admission as tadm
from k8s_dra_driver_tpu_torch.gateway import procpump as tpp
from k8s_dra_driver_tpu_torch.gateway import wire as tw
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import (kv_from_jax,
                                                     params_from_jax)
from k8s_dra_driver_tpu_torch.serving_disagg import wirekv as tkv
from k8s_dra_driver_tpu_torch.utils import backoff as tbackoff

pytestmark = pytest.mark.timeout_s(120)

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)


def frame(side_wire, msg) -> str:
    """The exact line ``send_msg`` writes."""
    buf = io.StringIO()
    side_wire.send_msg(buf, msg)
    return buf.getvalue()


def prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], n).astype(np.int32)


def arrays():
    rng = np.random.default_rng(0)
    return {
        "int32": rng.integers(-9, 9, (3, 4)).astype(np.int32),
        "uint32": rng.integers(0, 2 ** 32 - 1, (5,), dtype=np.uint32),
        "float32": rng.standard_normal((2, 3, 4)).astype(np.float32),
        "empty": np.array([], dtype=np.int32),
        "strided": np.arange(24, dtype=np.int32).reshape(4, 6)[:, ::2],
    }


# -- frame codecs --------------------------------------------------------

@pytest.mark.parametrize("name", sorted(arrays()))
def test_array_frames_byte_equal_and_cross_decode(name):
    """A numpy array and the torch tensor of the same values give JAX's
    frame byte for byte; each package decodes the other's."""
    a = arrays()[name]
    want = frame(jw, {"a": jw.encode_array(a)})
    assert frame(tw, {"a": tw.encode_array(a)}) == want
    assert frame(tw, {"a": tw.encode_array(torch.from_numpy(
        np.ascontiguousarray(a)))}) == want
    msg = tw.parse_frame(want)
    back = tw.decode_array(msg["a"])
    assert back.dtype == a.dtype and back.shape == a.shape
    np.testing.assert_array_equal(back, a)
    jback = jw.decode_array(jw.parse_frame(frame(tw, {"a": tw.encode_array(
        a)}))["a"])
    np.testing.assert_array_equal(jback, a)


def test_request_greq_finished_frames_byte_equal():
    """Requests, gateway records (arrival, deadline — an ``inf`` one —,
    requeues, tenant) and finished records: byte-equal frames, decoded
    across the packages with every field intact."""
    pr = prompt(3, 7)
    jreq = js.Request(uid="u1", prompt=pr, max_new=4, eos_id=5,
                      temperature=0.7, seed=11)
    treq = ts.Request(uid="u1", prompt=pr.copy(), max_new=4, eos_id=5,
                      temperature=0.7, seed=11)
    assert frame(tw, tw.encode_request(treq)) == frame(
        jw, jw.encode_request(jreq))
    for deadline in (17.25, float("inf")):
        jg = jadm.GatewayRequest(request=jreq, arrival_s=12.5,
                                 deadline_s=deadline, status="dispatched",
                                 requeues=2, tenant="hi")
        tg = tadm.GatewayRequest(request=treq, arrival_s=12.5,
                                 deadline_s=deadline, status="dispatched",
                                 requeues=2, tenant="hi")
        line = frame(jw, jw.encode_greq(jg))
        assert frame(tw, tw.encode_greq(tg)) == line
        back = tw.decode_greq(tw.parse_frame(line))
        assert (back.arrival_s, back.deadline_s, back.requeues,
                back.tenant, back.status) == (12.5, deadline, 2, "hi",
                                              "queued")
        assert isinstance(back.request, ts.Request)
        np.testing.assert_array_equal(back.request.prompt, pr)
        jback = jw.decode_greq(jw.parse_frame(frame(tw, tw.encode_greq(tg))))
        assert jback.deadline_s == deadline and jback.uid == "u1"
    toks = np.arange(7, dtype=np.int32)
    jf = js.Finished(uid="u1", tokens=toks, n_prompt=3)
    tf = ts.Finished(uid="u1", tokens=toks.copy(), n_prompt=3)
    line = frame(jw, jw.encode_finished(jf))
    assert frame(tw, tw.encode_finished(tf)) == line
    back = tw.decode_finished(tw.parse_frame(line))
    assert back.n_prompt == 3 and back.tokens.dtype == np.int32
    np.testing.assert_array_equal(back.tokens, toks)


def test_parse_frame_rejects_noise_and_non_objects():
    for side in (jw, tw):
        assert side.parse_frame("a stray print\n") is None
        assert side.parse_frame(side.TAG + "not json\n") is None
        assert side.parse_frame(side.TAG + "[1, 2]\n") is None
        assert side.parse_frame(side.TAG + '{"op": "x"}\n') == {"op": "x"}
    assert tw.TAG == jw.TAG


def test_bf16_round_trips_in_port_and_jax_v2_is_pinned():
    """The port carries bf16 bit for bit under its own tag, with the
    same payload bytes JAX writes; JAX's ``"<V2"`` frame decodes to a
    void array that ``jnp.asarray`` refuses."""
    vals = np.random.default_rng(1).standard_normal((3, 5)).astype(
        np.float32)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    enc = tw.encode_array(t)
    assert enc["dtype"] == tw.BF16_TAG == "bfloat16"
    back = tw.decode_array(json.loads(json.dumps(enc)))
    assert back.dtype == torch.bfloat16 and back.shape == t.shape
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    a = vals.astype(ml_dtypes.bfloat16)
    jenc = jw.encode_array(a)
    assert jenc["dtype"] == "<V2"
    assert jenc["b64"] == tw.encode_array(torch.from_numpy(
        a.view(np.int16)).view(torch.bfloat16))["b64"]
    jback = jw.decode_array(json.loads(json.dumps(jenc)))
    assert jback.dtype.str == "|V2"
    with pytest.raises(TypeError):
        jnp.asarray(jback)


def _pipe():
    r, w = os.pipe()
    return os.fdopen(r, "r"), os.fdopen(w, "w")


def test_wire_reader_noise_timeout_and_eof():
    """Untagged lines land in the noise ring; a quiet pipe is a
    retryable WireTimeout and the reader stays usable; EOF is a fatal
    WireClosed."""
    rd, wr = _pipe()
    reader = tw.WireReader(rd, name="t")
    wr.write("library warning\n")
    tw.send_msg(wr, {"id": 1})
    assert reader.recv(timeout_s=5.0) == {"id": 1}
    assert "library warning" in reader.noise_tail()
    with pytest.raises(tw.WireTimeout):
        reader.recv(timeout_s=0.05)
    tw.send_msg(wr, {"id": 2})
    wr.close()
    assert reader.recv(timeout_s=5.0) == {"id": 2}
    with pytest.raises(tw.WireClosed):
        reader.recv(timeout_s=5.0)
    assert issubclass(tw.WireTimeout, TimeoutError)
    assert issubclass(tw.WireClosed, ConnectionError)


# -- the pieces the pumps lean on ---------------------------------------

def test_bus_tap_drain_equal():
    """The pump's bus bridge gives JAX's JSON-safe (topic, payload)
    pairs, summarized at capture; untapped topics are not collected."""
    def run(bus_mod):
        bus = bus_mod.EventBus(seed=3)
        tap = bus_mod.BusTap(bus, ("drain", "demand"))
        bus.publish("drain", replica="r0", requeued=3)
        bus.publish("prefix", hit=True)
        bus.publish("demand", queue_depth=2, arrival_rate_rps=float("inf"),
                    slo_margin_ewma_s=None, big=list(range(20)),
                    obj=np.arange(300), deep={"a": {"b": {"c": {"d": 1}}}})
        bus.pump()
        out = tap.drain()
        assert tap.drain() == []
        return out

    got = run(tbus)
    assert got == run(jbus)
    assert [t for t, _ in got] == ["drain", "demand"]
    json.dumps(got)


def test_backoff_equal():
    for kw in (dict(), dict(duration_s=0.05, factor=2.0, jitter=0.0,
                            steps=64, cap_s=1.0, deadline_s=3.0),
               dict(jitter=0.5, steps=6, cap_s=3.0)):
        random.seed(7)
        want = jbackoff.Backoff(**kw).delays()
        random.seed(7)
        assert tbackoff.Backoff(**kw).delays() == want

    def drive(mod):
        t = [0.0]
        calls = []

        def fn():
            calls.append(t[0])
            return len(calls) == 4

        def sleep(dt):
            t[0] += dt

        ok = mod.Backoff(duration_s=0.5, jitter=0.0, steps=6, cap_s=1.0,
                         deadline_s=2.2).poll(fn, sleep=sleep,
                                              clock=lambda: t[0])
        return ok, calls

    assert drive(tbackoff) == drive(jbackoff)


RULES = {"seed": 5, "rules": [
    {"verb": "pump", "kind": "Pump", "name": "pump[01]", "skip": 1,
     "times": 2, "error": "crash"},
    {"verb": "health", "kind": "*", "name": "r*", "probability": 0.5,
     "times": -1, "error": "drop", "latency_s": 0.01},
    {"verb": "outcome.*", "times": 1, "error": "crash"}]}
CALLS = ([("pump", "Pump", f"pump{i % 3}") for i in range(8)]
         + [("health", "Replica", f"r{i % 2}") for i in range(12)]
         + [("outcome.appended", "", ""), ("outcome.committed", "", ""),
            ("create", "Pod", "x")])


def test_fault_plan_decisions_equal():
    """One seed, one rule set, one call sequence: the same decisions
    and the same injection log in both packages."""
    jp, tp = jfaults.FaultPlan.from_json(RULES), \
        tfaults.FaultPlan.from_json(json.dumps(RULES))
    assert tp.to_json() == jp.to_json()

    def summary(d):
        return None if d is None else (d.error, d.retry_after_s,
                                       d.latency_s, d.rule_index)

    assert ([summary(tp.decide(*c)) for c in CALLS]
            == [summary(jp.decide(*c)) for c in CALLS])
    assert tp.log == jp.log
    assert (tfaults.PUMP_VERB, tfaults.PUMP_KIND) == (jfaults.PUMP_VERB,
                                                      jfaults.PUMP_KIND)
    assert tfaults.CRASH_EXIT_CODE == jfaults.CRASH_EXIT_CODE
    assert tfaults.FAULT_PLAN_ENV == jfaults.FAULT_PLAN_ENV
    assert (tfaults.CRASH_OUTCOME_APPENDED, tfaults.CRASH_OUTCOME_COMMITTED
            ) == (jfaults.CRASH_OUTCOME_APPENDED,
                  jfaults.CRASH_OUTCOME_COMMITTED)
    with pytest.raises(ValueError):
        tfaults.FaultRule(error="boom")


@pytest.mark.parametrize("writer,reader", [(tfaults, jfaults),
                                           (jfaults, tfaults)])
def test_fault_plan_env_round_trip(tmp_path, monkeypatch, writer, reader):
    """A plan file written by one package loads in the other through
    ``TPU_DRA_FAULT_PLAN``."""
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(writer.FaultPlan.from_json(RULES).to_json()))
    monkeypatch.setenv(writer.FAULT_PLAN_ENV, str(path))
    plan = reader.load_plan_from_env()
    assert plan.to_json() == jfaults.FaultPlan.from_json(RULES).to_json()
    monkeypatch.delenv(writer.FAULT_PLAN_ENV)
    assert reader.load_plan_from_env() is None


@pytest.mark.parametrize("client,gateway", [(tcoord, jpp), (jcoord, tpp)])
def test_coordclient_registration_read_across(tmp_path, client, gateway):
    """A pump's registration file, written by one package's client, is
    read by the other package's conductor liveness check: fresh after
    register and heartbeat, infinitely old once unregistered."""
    c = client.CoordinatorClient(tmp_path, name="pump0")
    conductor = types.SimpleNamespace(ctl_dir=tmp_path)
    handle = types.SimpleNamespace(name="pump0")
    age = gateway.ProcessGateway._heartbeat_age_s
    assert age(conductor, handle) == float("inf")
    c.register()
    reg = json.loads((tmp_path / "ctl" / "pump0.json").read_text())
    assert set(reg) == {"pid", "weight", "registeredAtMs"}
    assert age(conductor, handle) < 5.0
    c.heartbeat()
    reg = json.loads((tmp_path / "ctl" / "pump0.json").read_text())
    assert "heartbeatAtMs" in reg and age(conductor, handle) < 5.0
    c.maybe_heartbeat()
    c.unregister()
    assert age(conductor, handle) == float("inf")
    assert tcoord.HEARTBEAT_INTERVAL_S == jcoord.HEARTBEAT_INTERVAL_S


# -- KV over the wire ----------------------------------------------------

@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, device="cpu")


def roundtrip(d) -> dict:
    return json.loads(json.dumps(d))


def assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_jax_kv_block_frame_decodes_in_port(params):
    """A JAX f32 greedy block encoded by JAX decodes in the port to
    ``kv_from_jax`` of the block (fresh storage); the port's frame of
    that converted block equals JAX's key for key and byte for byte;
    adopting the decoded block gives JAX's tokens."""
    jp, tp = params
    pr = prompt(21, 13)
    jeng = js.ServingEngine(jp, JCFG, slots=2)
    blk = jeng.prefill_export(js.Request(uid="x", prompt=pr, max_new=6))
    jenc = roundtrip(jkv.encode_kv_block(blk))
    jdec = js.ServingEngine(jp, JCFG, slots=2)
    jdec.adopt_block(jkv.decode_kv_block(jenc))
    want = np.asarray(jdec.run()[0].tokens)

    got = tkv.decode_kv_block(jenc, dest="cpu")
    ref = kv_from_jax(jax.tree.map(np.asarray, blk.kv), device="cpu")
    assert_leaves_equal(got.kv.k, ref.k)
    assert_leaves_equal(got.kv.v, ref.v)
    assert got.kv.k_scale is None and got.carry is None
    assert (got.kv.pos, got.first, got.reused_tokens) == (
        13, int(blk.first), int(blk.reused_tokens))
    tenc = tkv.encode_kv_block(ts.KVBlock(
        request=ts.Request(uid="x", prompt=pr, max_new=6), kv=ref,
        first=int(blk.first)))
    assert list(tenc) == list(jenc)
    assert json.dumps(tenc) == json.dumps(jenc)
    assert tkv.frame_bytes(tenc) == jkv.frame_bytes(jenc)
    dec = ts.ServingEngine(tp, TCFG, slots=2, device="cpu")
    dec.adopt_block(got)
    np.testing.assert_array_equal(dec.run()[0].tokens, want)


def test_jax_paged_slab_rechunks_in_port(params):
    """A JAX paged slab frame (block size 8) decodes in the port, kept
    as sent or re-chunked to block size 4, to JAX's own decode of the
    frame; the port's frame of ``kv_from_jax`` of the slab equals JAX's;
    the re-chunked slab adopted by a block-size-4 port engine gives the
    tokens a block-size-4 JAX engine gives the same slab."""
    jp, tp = params
    pr = prompt(22, 13)
    jeng = js.ServingEngine(jp, JCFG, slots=2, kv_layout="paged",
                            kv_block_size=8)
    blk = jeng.prefill_export(js.Request(uid="p", prompt=pr, max_new=6))
    jenc = roundtrip(jkv.encode_paged_slab(blk.kv))
    ref = kv_from_jax(jax.tree.map(np.asarray, blk.kv), device="cpu")
    assert json.dumps(tkv.encode_paged_slab(ref)) == json.dumps(jenc)
    for bs in (None, 4):
        got = tkv.decode_paged_slab(jenc, block_size=bs, dest="cpu")
        want = jkv.decode_paged_slab(jenc, block_size=bs)
        assert (got.pos, got.block_size) == (13, bs or 8)
        for g, w in zip(got.k + got.v, want.k + want.v):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got.k[0].shape[0] == -(-13 // (bs or 8))
    jdec = js.ServingEngine(jp, JCFG, slots=2, kv_layout="paged",
                            kv_block_size=4)
    jdec.adopt_block(js.KVBlock(
        request=js.Request(uid="p", prompt=pr, max_new=6),
        kv=jkv.decode_paged_slab(jenc, block_size=4), first=blk.first))
    want_toks = np.asarray(jdec.run()[0].tokens)
    dec = ts.ServingEngine(tp, TCFG, slots=2, kv_layout="paged",
                           kv_block_size=4, device="cpu")
    dec.adopt_block(ts.KVBlock(
        request=ts.Request(uid="p", prompt=pr, max_new=6),
        kv=tkv.decode_paged_slab(jenc, block_size=4, dest="cpu"),
        first=int(blk.first)))
    np.testing.assert_array_equal(dec.run()[0].tokens, want_toks)


def test_jax_sampled_frame_refused_by_port_adopt_gate(params):
    """A JAX sampled block carries a PRNG key (uint32[2]); it decodes,
    and the port engine's generator-state gate refuses it before any
    state changes."""
    jp, tp = params
    jeng = js.ServingEngine(jp, JCFG, slots=2)
    blk = jeng.prefill_export(js.Request(uid="s", prompt=prompt(23, 9),
                                         max_new=4, temperature=0.8,
                                         seed=13))
    jenc = roundtrip(jkv.encode_kv_block(blk))
    assert jenc["carry_key"]["dtype"] == "<u4"
    got = tkv.decode_kv_block(jenc, dest="cpu")
    assert got.carry.numel() == 2
    dec = ts.ServingEngine(tp, TCFG, slots=2, device="cpu")
    with pytest.raises(ValueError, match="generator state"):
        dec.adopt_block(got)
    assert dec.active == 0


def cast(node, dtype):
    if isinstance(node, dict):
        return {k: cast(v, dtype) for k, v in node.items()}
    if isinstance(node, list):
        return [cast(v, dtype) for v in node]
    return node.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_block_round_trip(params, dtype):
    """A port block (greedy and sampled) through encode -> JSON ->
    decode: every leaf bit-equal, the carry intact, and the adopted
    block continues as the exporter's own block does.  A paged export
    is refused by the dense codec."""
    _, tp = params
    cfg = tt.TransformerConfig(dtype=dtype, **FIELDS)
    p = cast(tp, dtype)
    eng = ts.ServingEngine(p, cfg, slots=2, device="cpu", top_k=8)
    for req in (ts.Request(uid="g", prompt=prompt(24, 11), max_new=5),
                ts.Request(uid="s", prompt=prompt(25, 7), max_new=5,
                           temperature=0.8, seed=3)):
        blk = eng.prefill_export(req)
        enc = roundtrip(tkv.encode_kv_block(blk))
        want_tag = "bfloat16" if dtype == torch.bfloat16 else "<f4"
        assert enc["k"][0]["dtype"] == want_tag
        got = tkv.decode_kv_block(enc, dest="cpu")
        for g, w in zip(got.kv.tensors(), blk.kv.tensors()):
            assert g.dtype == w.dtype and g.data_ptr() != w.data_ptr()
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
        if req.temperature > 0:
            assert torch.equal(got.carry, blk.carry)
        toks = []
        for b in (blk, got):
            eng.adopt_block(b)
            toks.append(eng.run()[0].tokens)
        np.testing.assert_array_equal(toks[1], toks[0])
    paged = ts.ServingEngine(p, cfg, slots=2, device="cpu",
                             kv_layout="paged", kv_block_size=8)
    with pytest.raises(TypeError):
        tkv.encode_kv_block(paged.prefill_export(
            ts.Request(uid="q", prompt=prompt(26, 9), max_new=2)))
