"""Port watchdog, layouts, sharded checkpoint format, recovery metrics
and the supervisor's trace hook (k8s_dra_driver_tpu_torch/utils/
watchdog.py, models/layouts.py, parallel/resharding.py,
utils/metrics.py ``RecoveryMetrics``, utils/tracing.py
``attach_supervisor``, serving_lora/pool.py ``checkpoint_source``)
against the JAX package's, on the CPU.

Both packages run on the same inputs: heartbeat files written by one
are classified by the other's monitor; the rule tables encode to the
same lists; a sharded generation written by JAX (from a dp=2 x tp=1
and a dp=1 x tp=2 mesh, several shards a leaf) restores bit-equal into
the port, optax's adamw names included, and steps on to JAX's loss;
a port generation restores into JAX; the manifests agree leaf for
leaf, a port save from a dp=2 x tp=4 formation shard for shard with
JAX's from that mesh; every corruption class falls back to the same step in both; the
crashpoints fire through a real ``os._exit`` in a subprocess.
"""

import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.cluster import faults as jfaults
from k8s_dra_driver_tpu.models import layouts as jlayouts
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.parallel import resharding as jres
from k8s_dra_driver_tpu.parallel.mesh import MeshSpec as JMeshSpec
from k8s_dra_driver_tpu.parallel.mesh import make_mesh as jmake_mesh
from k8s_dra_driver_tpu.utils import metrics as jmetrics
from k8s_dra_driver_tpu.utils import tracing as jtracing
from k8s_dra_driver_tpu.utils import watchdog as jwd
from k8s_dra_driver_tpu_torch.cluster import faults as tfaults
from k8s_dra_driver_tpu_torch.models import layouts as tlayouts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.parallel import mesh as tmesh
from k8s_dra_driver_tpu_torch.parallel import resharding as tres
from k8s_dra_driver_tpu_torch.parallel.mesh import P as TP
from k8s_dra_driver_tpu_torch.utils import metrics as tmetrics
from k8s_dra_driver_tpu_torch.utils import tracing as ttracing
from k8s_dra_driver_tpu_torch.utils import watchdog as twd

REPO = Path(__file__).parent.parent

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=16)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)
#: tests/test_torch_train.py's tolerance for a port step against JAX's
LOSS_RTOL = 1e-5


def JP(*args):
    from jax.sharding import PartitionSpec
    return PartitionSpec(*args)


def batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, FIELDS["vocab"], (4, 16)).astype(np.int32)
            for _ in range(n)]


# -- the watchdog -------------------------------------------------------------

@pytest.mark.parametrize("wd", [jwd, twd], ids=["jax", "torch"])
def test_run_with_deadline_returns_reraises_and_times_out(wd):
    assert wd.run_with_deadline(lambda: 41 + 1, 5.0) == 42
    with pytest.raises(ZeroDivisionError):
        wd.run_with_deadline(lambda: 1 / 0, 5.0)
    release = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(wd.WatchdogTimeout) as exc:
        wd.run_with_deadline(lambda: release.wait(60), 0.2,
                             label="wedged region")
    assert time.monotonic() - t0 < 5.0
    assert "wedged region" in str(exc.value)
    release.set()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_heartbeat_files_classify_alike(tmp_path, writer):
    """A heartbeat written by either package reads the same through
    both monitors, at every scripted age."""
    w = {"jax": jwd, "torch": twd}[writer]
    hb = w.WorkerHeartbeat(tmp_path, "w0")
    monitors = [wd.HeartbeatMonitor(tmp_path, soft_s=1.0, hard_s=3.0)
                for wd in (jwd, twd)]
    assert {m.classify("nobody") for m in monitors} == {"missing"}
    hb.beat(7, "begin")
    assert (jwd.heartbeat_path(tmp_path, "w0")
            == twd.heartbeat_path(tmp_path, "w0") == hb.path)
    rec = monitors[1].read("w0")
    assert rec == monitors[0].read("w0")
    assert rec["step"] == 7 and rec["phase"] == "begin"
    for age, want in ((0.5, "ok"), (2.0, "slow"), (4.0, "wedged")):
        assert [m.classify("w0", now=rec["t"] + age)
                for m in monitors] == [want, want]
    hb.tombstone(86)
    assert [m.classify("w0", now=rec["t"] + 100)
            for m in monitors] == ["dead", "dead"]
    for wd in (jwd, twd):
        with pytest.raises(ValueError):
            wd.HeartbeatMonitor(tmp_path, soft_s=3.0, hard_s=1.0)


# -- layouts and rules --------------------------------------------------------

def encoded(rules, enc):
    return [(pat, enc(spec)) for pat, spec in rules]


CONFIGS = {"dense": {}, "moe": {"n_experts": 4, "top_k": 2},
           "pp": {"pp_stages": 2},
           "moe_pp": {"n_experts": 4, "top_k": 2, "pp_stages": 2},
           "gqa": {"n_kv_heads": 2}}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rule_tables_encode_as_jax(name):
    kw = CONFIGS[name]
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **FIELDS, **kw)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **FIELDS, **kw)
    assert (encoded(tlayouts.transformer_rules(tcfg), tres.encode_spec)
            == encoded(jlayouts.transformer_rules(jcfg), jres.encode_spec))
    assert (encoded(tlayouts.lora_rules(tcfg), tres.encode_spec)
            == encoded(jlayouts.lora_rules(jcfg), jres.encode_spec))
    assert tlayouts.LORA_TARGETS == jlayouts.LORA_TARGETS


@pytest.mark.parametrize("name", ["dense", "moe", "gqa"])
def test_rules_place_every_leaf_as_jax_param_specs(name):
    """match_partition_rules over the port's parameter tree gives the
    JAX package's ``param_specs``, leaf for leaf."""
    kw = CONFIGS[name]
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **FIELDS, **kw)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **FIELDS, **kw)
    params = tt.init_params(tcfg, device="cpu")
    got = {tres.leaf_name(p): tres.encode_spec(s)
           for p, s in tres.tree_flatten_with_path(
               tres.match_partition_rules(
                   tlayouts.transformer_rules(tcfg), params))}
    flat, _ = jax.tree_util.tree_flatten_with_path(jt.param_specs(jcfg))
    want = {jres.leaf_name(p): jres.encode_spec(s) for p, s in flat}
    assert got == want
    assert tres.tree_leaf_names(params) == list(want)


SIDES = {"jax": (jres, JP), "torch": (tres, TP)}


@pytest.mark.parametrize("side", sorted(SIDES))
def test_match_partition_rules_contract(side):
    res, P = SIDES[side]
    tree = {"wq": np.zeros((4, 4))}
    specs = res.match_partition_rules(
        [(r"w", P("tp", None)), (r"wq", P(None, "tp"))], tree)
    assert res.encode_spec(specs["wq"]) == ["tp", None]
    specs = res.match_partition_rules(
        [(r"wq", P(None, "tp")), (r"w", P("tp", None))], tree)
    assert res.encode_spec(specs["wq"]) == [None, "tp"]
    bad = {"wq": np.zeros((4, 4)), "mystery": np.zeros((2, 2))}
    with pytest.raises(ValueError, match="mystery") as err:
        res.match_partition_rules([(r"wq", P(None))], bad)
    assert "layouts.py" in str(err.value)
    scal = {"count": np.float32(3.0), "one": np.zeros((1,)),
            "wq": np.zeros((4, 4))}
    specs = res.match_partition_rules([(r"wq", P("tp", None))], scal)
    assert [res.encode_spec(specs[k]) for k in ("count", "one", "wq")] \
        == [[], [], ["tp", None]]
    assert set(res.tree_leaf_names(
        {"layers": [{"wq": 0, "wo": 0}], "embed": 0})) == {
        "embed", "layers/0/wq", "layers/0/wo"}


def test_spec_json_roundtrip_equals_jax():
    for entries in ((), (None,), ("tp", None), (("dp", "sp"), "tp"),
                    (None, ("ep",), "tp")):
        t, j = TP(*entries), JP(*entries)
        assert tres.encode_spec(t) == jres.encode_spec(j)
        assert tres.decode_spec(tres.encode_spec(t)) == t
        assert tuple(tres.decode_spec(jres.encode_spec(j))) == tuple(t)


# -- the adamw name map -------------------------------------------------------

def test_adamw_leaves_map_and_fresh_state():
    """A fresh optimizer maps to optax's init (zero moments, count 0);
    restoring that state leaves an optimizer whose next step equals a
    fresh one's; after steps, the map carries torch's moments and
    step."""
    step, init_state = tt.make_train_step(TCFG, device="cpu")
    params, opt = init_state(torch.Generator().manual_seed(0))
    leaves = tres.adamw_leaves(params, opt)
    names = [n for n, _ in tt.named_tensors(params)]
    want = (["0/count"]
            + [f"0/{m}/{n.replace('.', '/')}" for m in ("mu", "nu")
               for n in names])
    assert sorted(leaves) == sorted(want)
    assert leaves["0/count"].dtype == torch.int32
    assert int(leaves["0/count"]) == 0
    assert all(not v.any() for k, v in leaves.items() if k != "0/count")
    # zero state loaded: the next step equals a fresh optimizer's
    params2, opt2 = init_state(torch.Generator().manual_seed(0))
    tres.load_adamw_leaves(params2, opt2, leaves)
    b = batches(1)[0]
    _, _, l1 = step(params, opt, b)
    _, _, l2 = step(params2, opt2, b)
    assert float(l1) == float(l2)
    for (_, a), (_, c) in zip(tt.named_tensors(params),
                              tt.named_tensors(params2)):
        assert torch.equal(a, c)
    after = tres.adamw_leaves(params, opt)
    assert int(after["0/count"]) == 1
    p0 = tt.named_tensors(params)[0][1]
    assert torch.equal(after[f"0/mu/{names[0]}"],
                       opt.state[p0]["exp_avg"])
    assert torch.equal(after[f"0/nu/{names[0]}"],
                       opt.state[p0]["exp_avg_sq"])
    with pytest.raises(ValueError, match="not bound"):
        tres.adamw_leaves({"embed": params["embed"]}, opt)
    sgd = torch.optim.SGD([t for _, t in tt.named_tensors(params)], lr=0.1)
    with pytest.raises(TypeError, match="AdamW"):
        tres.adamw_leaves(params, sgd)


def jax_train(mesh, steps, seed=0):
    step, init = jt.make_train_step(JCFG, mesh)
    p, o = init(jax.random.PRNGKey(seed))
    for b in batches(steps):
        p, o, _ = step(p, o, b)
    return step, p, o


def host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2)])
def test_jax_generation_restores_bit_equal_into_the_port(tmp_path, dp, tp):
    mesh = jmake_mesh(JMeshSpec(dp=dp, tp=tp), jax.devices()[:dp * tp])
    jstep, p, o = jax_train(mesh, 2)
    jres.ShardedCheckpointer(tmp_path / "ckpt").save(
        2, p, o, extra={"epoch": 0, "step": 2})
    hp, ho = host(p), host(o)
    nxt = batches(3)[2]
    _, _, jloss = jstep(p, o, nxt)

    ckpt = tres.ShardedCheckpointer(tmp_path / "ckpt")
    leaves = ckpt._read_manifest(ckpt.step_path(2))["leaves"]
    if tp == 2:   # the head-split leaves carry several shards
        assert len(leaves["params/layers/0/wq"]["shards"]) == 2
    tstep, tinit = tt.make_train_step(TCFG, device="cpu")
    params, opt = tinit(torch.Generator().manual_seed(3))
    params, opt, at = ckpt.restore(params, opt)
    assert at == 2 and ckpt.restore_extra(at) == {"epoch": 0, "step": 2}
    assert ckpt.last_restore_stats["files_read"] == sum(
        len(e["shards"]) for e in leaves.values())
    mu, nu = ho[0].mu, ho[0].nu
    for name, t in tt.named_tensors(params):
        path = name.split(".")
        want = hp
        m, n = mu, nu
        for k in path:
            k = int(k) if k.isdigit() else k
            want, m, n = want[k], m[k], n[k]
        np.testing.assert_array_equal(t.detach().numpy(), want)
        st = opt.state[t]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), m)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), n)
        assert float(st["step"]) == int(ho[0].count) == 2
    _, _, tloss = tstep(params, opt, nxt)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=LOSS_RTOL)


def test_port_generation_restores_into_jax(tmp_path):
    mesh = jmake_mesh(JMeshSpec(dp=2, tp=1), jax.devices()[:2])
    jstep, jinit = jt.make_train_step(JCFG, mesh)
    jp0, _ = jinit(jax.random.PRNGKey(0))
    tstep, tinit = tt.make_train_step(TCFG, device="cpu")
    params, opt = tinit()
    with torch.no_grad():
        for (_, t), v in zip(tt.named_tensors(params),
                             jax.tree.leaves(host(jp0))):
            t.copy_(torch.from_numpy(np.array(v)))
    for b in batches(2):
        params, opt, _ = tstep(params, opt, b)
    tres.ShardedCheckpointer(
        tmp_path / "ckpt", rules=tlayouts.transformer_rules(TCFG)).save(
        2, params, opt, extra={"epoch": 0, "step": 2})
    p, o = jinit(jax.random.PRNGKey(5))
    p, o, at = jres.ShardedCheckpointer(tmp_path / "ckpt").restore(p, o)
    assert at == 2
    assert int(o[0].count) == 2
    for (_, t), v, m, n in zip(tt.named_tensors(params),
                               jax.tree.leaves(p), jax.tree.leaves(o[0].mu),
                               jax.tree.leaves(o[0].nu)):
        np.testing.assert_array_equal(np.asarray(v), t.detach().numpy())
        np.testing.assert_array_equal(np.asarray(m),
                                      opt.state[t]["exp_avg"].numpy())
        np.testing.assert_array_equal(np.asarray(n),
                                      opt.state[t]["exp_avg_sq"].numpy())
    nxt = batches(3)[2]
    _, _, jloss = jstep(p, o, nxt)
    _, _, tloss = tstep(params, opt, nxt)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=LOSS_RTOL)


def test_manifest_leaves_equal_jax_at_tp1(tmp_path):
    """The same values saved by both packages (JAX from a dp=2 x tp=1
    mesh, the port with the transformer's rules): every manifest leaf
    equal — shape, dtype, spec, shard files, bounds, crc32, nbytes."""
    mesh = jmake_mesh(JMeshSpec(dp=2, tp=1), jax.devices()[:2])
    _, jinit = jt.make_train_step(JCFG, mesh)
    p, o = jinit(jax.random.PRNGKey(0))
    jres.ShardedCheckpointer(tmp_path / "j").save(0, p, o)
    _, tinit = tt.make_train_step(TCFG, device="cpu")
    params, opt = tinit()
    with torch.no_grad():
        for (_, t), v in zip(tt.named_tensors(params),
                             jax.tree.leaves(host(p))):
            t.copy_(torch.from_numpy(np.array(v)))
    tck = tres.ShardedCheckpointer(
        tmp_path / "t", rules=tlayouts.transformer_rules(TCFG))
    tck.save(0, params, opt)
    jm = tck._read_manifest(tmp_path / "j" / "step_00000000")
    tm = tck._read_manifest(tck.step_path(0))
    assert sorted(tm["leaves"]) == sorted(jm["leaves"])
    for name, ent in jm["leaves"].items():
        got = tm["leaves"][name]
        if name.startswith("params/") or name.endswith("/count"):
            assert got == ent, name
        else:
            # the moments' placement is the optimizer's, not the rules'
            assert {k: v for k, v in got.items() if k != "spec"} \
                == {k: v for k, v in ent.items() if k != "spec"}, name
    assert {k: v for k, v in tm.items() if k != "leaves"} \
        == {k: v for k, v in jm.items() if k != "leaves"}


def test_manifest_leaves_equal_jax_at_dp2_tp4(tmp_path):
    """A port save handed the formation (``mesh=MeshSpec(dp=2, tp=4)``)
    cuts each leaf into the blocks JAX writes from the same weights on
    a dp=2 x tp=4 mesh: every manifest leaf equal, shard for shard —
    names, shapes, dtypes, specs, bounds, crc32.  The two generations
    then restore across the packages both ways, bit-equal."""
    mesh = jmake_mesh(JMeshSpec(dp=2, tp=4), jax.devices()[:8])
    _, jinit = jt.make_train_step(JCFG, mesh)
    p, o = jinit(jax.random.PRNGKey(0))
    jck = jres.ShardedCheckpointer(tmp_path / "j")
    jck.save(0, p, o)
    _, tinit = tt.make_train_step(TCFG, device="cpu")
    params, opt = tinit()
    with torch.no_grad():
        for (_, t), v in zip(tt.named_tensors(params),
                             jax.tree.leaves(host(p))):
            t.copy_(torch.from_numpy(np.array(v)))
    tck = tres.ShardedCheckpointer(
        tmp_path / "t", rules=tlayouts.transformer_rules(TCFG))
    tck.save(0, params, opt, mesh=tmesh.MeshSpec(dp=2, tp=4))
    jm = tck._read_manifest(tmp_path / "j" / "step_00000000")
    tm = tck._read_manifest(tck.step_path(0))
    assert sorted(tm["leaves"]) == sorted(jm["leaves"])
    sharded = 0
    for name, ent in jm["leaves"].items():
        assert tm["leaves"][name] == ent, name
        sharded += len(ent["shards"]) == 4
    assert sharded >= 3 * 4 * FIELDS["n_layers"]     # wq/wk/wv/wo, w_*
    # across the packages, both ways
    got_p, got_o, at = tck.restore(*tinit())
    assert at == 0
    for (name, a), (_, b) in zip(tt.named_tensors(got_p),
                                 tt.named_tensors(params)):
        assert torch.equal(a, b), name
    jp, jo, at = jck.restore(*jinit(jax.random.PRNGKey(5)))
    tp_, to_, _ = tres.ShardedCheckpointer(tmp_path / "j").restore(
        *tinit())
    for (name, a), v in zip(tt.named_tensors(tp_), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(v))
    jp2, _, _ = jres.ShardedCheckpointer(tmp_path / "t").restore(
        *jinit(jax.random.PRNGKey(5)))
    for (name, a), v in zip(tt.named_tensors(params), jax.tree.leaves(jp2)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(v))


def test_resharding_probe_has_the_reference_keys():
    """``resharding_probe`` on the port: the reference's keys, the same
    model bytes saved from dp=2 x tp=4 (4 shards a tp-sharded leaf) and
    the flipped shard detected."""
    from k8s_dra_driver_tpu.parallel.probe import resharding_probe as jprobe
    from k8s_dra_driver_tpu_torch.parallel import resharding_probe
    got = resharding_probe(repeats=1, device="cpu")
    want = jprobe(repeats=1)
    assert sorted(got) == sorted(want)
    assert got["model_mb"] == want["model_mb"]
    assert got["shards_per_leaf"] == 4
    assert got["corrupt_detected"] == want["corrupt_detected"] == 1


# -- corruption classes -------------------------------------------------------

def tree(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return {f"leaf{i}": rng.standard_normal((8, 16)).astype(np.float32)
            for i in range(n)}


def like(t):
    return {k: np.zeros_like(v) for k, v in t.items()}


@pytest.mark.parametrize("damage", ["bitflip", "truncate", "missing",
                                    "manifest"])
def test_corruption_falls_back_alike(tmp_path, damage):
    """The same damage to the same file of both packages' generations:
    both fall back to step 1 with its values, both raise under an
    explicit ``step=2``."""
    good = tree(1)
    for side, res in (("jax", jres), ("torch", tres)):
        ckpt = res.ShardedCheckpointer(tmp_path / side)
        ckpt.save(1, good, {})
        ckpt.save(2, tree(2), {})
        victim = sorted(ckpt.step_path(2).glob("*.bin"))[0]
        if damage == "bitflip":
            tfaults.corrupt_file(victim, tfaults.CORRUPT_BITFLIP, seed=3)
        elif damage == "truncate":
            tfaults.corrupt_file(victim, tfaults.CORRUPT_TRUNCATE, seed=3)
        elif damage == "missing":
            victim.unlink()
        else:
            (ckpt.step_path(2) / res.MANIFEST).write_text("{not json")
        p, _, at = ckpt.restore(like(good), {})
        assert at == 1, side
        np.testing.assert_array_equal(p["leaf0"], good["leaf0"])
        with pytest.raises(res.ShardCorruption):
            ckpt.restore(like(good), {}, step=2)
        for s in (1, 2):
            tfaults.corrupt_file(
                sorted(ckpt.step_path(s).glob("*.bin"))[-1],
                tfaults.CORRUPT_BITFLIP, seed=s)
        with pytest.raises(FileNotFoundError, match="no restorable"):
            ckpt.restore(like(good), {})


def test_sharded_format_contract(tmp_path):
    """The reference's format tests on the port: roundtrip with extra,
    an uncommitted generation is invisible, a committed step is never
    rewritten, keep-newest pruning, truncation caught with verify off,
    slice reads open only the intersecting shards of a reference
    generation with several shards a leaf."""
    ckpt = tres.ShardedCheckpointer(tmp_path / "a", keep=3)
    t = tree()
    ckpt.save(7, t, {"m": t["leaf0"] * 2}, extra={"epoch": 3})
    p, o, at = ckpt.restore(like(t), {"m": np.zeros_like(t["leaf0"])})
    assert at == 7 and ckpt.restore_extra(7) == {"epoch": 3}
    np.testing.assert_array_equal(o["m"], t["leaf0"] * 2)
    ckpt.save(7, tree(9), {})
    np.testing.assert_array_equal(
        ckpt.restore(like(t), {})[0]["leaf1"], t["leaf1"])
    for s in (8, 9, 10):
        ckpt.save(s, tree(s), {})
    assert ckpt.all_steps() == [8, 9, 10]
    (ckpt.step_path(10) / tres.MANIFEST).unlink()
    assert ckpt.all_steps() == [8, 9]
    nv = tres.ShardedCheckpointer(tmp_path / "a", verify=False)
    tfaults.corrupt_file(sorted(nv.step_path(9).glob("*.bin"))[0],
                         tfaults.CORRUPT_TRUNCATE, seed=0)
    with pytest.raises(tres.ShardCorruption, match="truncated"):
        nv.restore(like(t), {}, step=9)

    from jax.sharding import NamedSharding
    mesh = jmake_mesh(JMeshSpec(dp=2, tp=4))
    full = np.arange(64 * 16, dtype=np.float32).reshape(64, 16)
    arr = jax.device_put(full, NamedSharding(mesh, JP("tp", None)))
    jres.ShardedCheckpointer(tmp_path / "b").save(0, {"big": arr}, {})
    rd = tres.ShardedCheckpointer(tmp_path / "b")
    out = rd.read_slice(0, "params/big", bounds=[[0, 16], [0, 16]])
    assert rd.last_restore_stats["files_read"] == 1
    np.testing.assert_array_equal(out, full[:16])
    rd.read_slice(0, "params/big", bounds=[[8, 40], [0, 16]])
    assert rd.last_restore_stats["files_read"] == 3
    np.testing.assert_array_equal(rd.read_slice(0, "params/big"), full)
    assert rd.last_restore_stats["files_read"] == 4
    with pytest.raises(tres.ShardCorruption, match="missing leaf"):
        rd.read_slice(0, "params/nope")


def test_bf16_leaves_cross_both_ways(tmp_path):
    """bfloat16 is written as the reference writes it (dtype name,
    two bytes an element): a JAX bf16 leaf restores bit-equal into a
    bf16 tensor, and a port bf16 leaf reads back in JAX."""
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((8, 16)).astype(np.float32)
    jarr = jnp.asarray(vals, dtype=jnp.bfloat16)
    jres.ShardedCheckpointer(tmp_path / "j").save(0, {"w": jarr}, {})
    target = {"w": torch.zeros((8, 16), dtype=torch.bfloat16)}
    tres.ShardedCheckpointer(tmp_path / "j").restore(target, {})
    want = torch.from_numpy(np.array(jarr.astype(jnp.float32)))
    assert torch.equal(target["w"].float(), want)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    tres.ShardedCheckpointer(tmp_path / "t").save(0, {"w": t}, {})
    back, _, _ = jres.ShardedCheckpointer(tmp_path / "t").restore(
        {"w": jnp.zeros((8, 16), jnp.bfloat16)}, {})
    np.testing.assert_array_equal(
        np.asarray(back["w"]).astype(np.float32), t.float().numpy())
    np.testing.assert_array_equal(
        tres.ShardedCheckpointer(tmp_path / "t").read_slice(0, "params/w"),
        t.float().numpy())


# -- crashpoints, torn for real -----------------------------------------------

def run_child(body: str, *args):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(body), *map(str, args)],
        capture_output=True, text=True, timeout=240, cwd=REPO)


RESHARD_CHILD = """
    import sys
    import numpy as np
    from {pkg}.cluster import faults
    from {pkg}.cluster.faults import FaultPlan, FaultRule
    from {pkg}.parallel.resharding import ShardedCheckpointer
    ckpt = ShardedCheckpointer(sys.argv[1])
    ckpt.save(1, {{"w": np.ones((8, 8), np.float32)}}, {{}})
    faults.install_process_plan(FaultPlan([FaultRule(
        verb={point!r}, times=1, error="crash")]))
    ckpt.save(2, {{"w": np.zeros((8, 8), np.float32)}}, {{}})
    raise SystemExit("crashpoint never fired")
"""


@pytest.mark.parametrize("pkg", ["k8s_dra_driver_tpu",
                                 "k8s_dra_driver_tpu_torch"],
                         ids=["jax", "torch"])
def test_reshard_crash_before_manifest_is_invisible(tmp_path, pkg):
    proc = run_child(RESHARD_CHILD.format(
        pkg=pkg, point=tfaults.CRASH_RESHARD_SHARDS_WRITTEN),
        tmp_path / "ckpt")
    assert proc.returncode == tfaults.CRASH_EXIT_CODE, proc.stderr
    ckpt = tres.ShardedCheckpointer(tmp_path / "ckpt")
    assert ckpt.step_path(2).exists()
    assert not (ckpt.step_path(2) / tres.MANIFEST).exists()
    assert ckpt.all_steps() == [1]
    p, _, at = ckpt.restore({"w": np.zeros((8, 8), np.float32)}, {})
    assert at == 1
    np.testing.assert_array_equal(p["w"], np.ones((8, 8)))
    ckpt.save(2, {"w": np.full((8, 8), 2, np.float32)}, {})
    assert ckpt.all_steps() == [1, 2]


def test_reshard_crash_after_commit_is_restorable(tmp_path):
    proc = run_child(RESHARD_CHILD.format(
        pkg="k8s_dra_driver_tpu_torch",
        point=tfaults.CRASH_RESHARD_COMMITTED), tmp_path / "ckpt")
    assert proc.returncode == tfaults.CRASH_EXIT_CODE, proc.stderr
    for res in (jres, tres):
        p, _, at = res.ShardedCheckpointer(tmp_path / "ckpt").restore(
            {"w": np.ones((8, 8), np.float32)}, {})
        assert at == 2
        np.testing.assert_array_equal(p["w"], np.zeros((8, 8)))


TRAIN_CHILD = """
    import sys
    import torch
    from k8s_dra_driver_tpu_torch.cluster import faults
    from k8s_dra_driver_tpu_torch.cluster.faults import FaultPlan, FaultRule
    from k8s_dra_driver_tpu_torch.models import transformer as tt
    from k8s_dra_driver_tpu_torch.models.checkpoint import TrainCheckpointer
    cfg = tt.TransformerConfig(vocab=64, d_model=32, n_layers=2,
                               n_heads=4, d_head=8, d_ff=64, max_seq=16,
                               dtype=torch.float32)
    _, init_state = tt.make_train_step(cfg, device="cpu")
    params, opt = init_state()
    ckpt = TrainCheckpointer(sys.argv[1])
    if {first}:
        ckpt.save(1, params, opt)
    faults.install_process_plan(FaultPlan([FaultRule(
        verb={point!r}, times=1, error="crash")]))
    ckpt.save(2, params, opt)
    raise SystemExit("crashpoint never fired")
"""


@pytest.mark.parametrize("point,first,want", [
    (tfaults.CRASH_TRAIN_CKPT_SAVING, True, 1),
    (tfaults.CRASH_TRAIN_CKPT_COMMITTED, False, 2)],
    ids=["saving", "committed"])
def test_train_ckpt_crashpoints(tmp_path, point, first, want):
    """``train_ckpt.saving``: the write in flight, the generation never
    appears and restore degrades to the previous one.
    ``train_ckpt.committed``: renamed but no integrity sidecar, which
    verifies trivially and restores."""
    from k8s_dra_driver_tpu_torch.models.checkpoint import \
        TrainCheckpointer
    proc = run_child(TRAIN_CHILD.format(point=point, first=first),
                     tmp_path / "ckpt")
    assert proc.returncode == tfaults.CRASH_EXIT_CODE, proc.stderr
    assert point == getattr(jfaults, {
        tfaults.CRASH_TRAIN_CKPT_SAVING: "CRASH_TRAIN_CKPT_SAVING",
        tfaults.CRASH_TRAIN_CKPT_COMMITTED:
            "CRASH_TRAIN_CKPT_COMMITTED"}[point])
    _, init_state = tt.make_train_step(TCFG, device="cpu")
    params, opt = init_state(torch.Generator().manual_seed(7))
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    assert ckpt.all_steps() == ([1] if first else [2])
    assert not (tmp_path / "ckpt-integrity" / "2.json").exists()
    _, _, at = ckpt.restore(params, opt)
    assert at == want
    ckpt.close()


def test_fault_names_equal_jax():
    for name in ("GANG_VERB", "GANG_WORKER_KIND",
                 "CRASH_RESHARD_SHARDS_WRITTEN", "CRASH_RESHARD_COMMITTED",
                 "CRASH_TRAIN_CKPT_SAVING", "CRASH_TRAIN_CKPT_COMMITTED"):
        assert getattr(tfaults, name) == getattr(jfaults, name), name


# -- recovery metrics, trace hook, adapter source -----------------------------

def test_recovery_metrics_render_as_jax():
    renders = []
    for m in (jmetrics.RecoveryMetrics(), tmetrics.RecoveryMetrics()):
        m.set_state("running", ("running", "suspect", "evict"))
        m.restarts.labels(cause="dead").inc()
        m.restarts.labels(cause="preempt").inc()
        m.evicted_workers.inc(2)
        m.steps_lost.inc(3)
        m.steps_lost_last.set(3)
        m.dp_width.set(2)
        for s in (0.3, 1.7, 45.0):
            m.observe_recovery(s)
        m.set_state("evict", ("running", "suspect", "evict"))
        renders.append([ln for ln in m.render().decode().splitlines()
                        if "_created" not in ln])
    assert renders[1] == renders[0]


def test_attach_supervisor_spans_as_jax():
    script = [("suspect", {"from": "running", "dp": 4, "step": 3,
                           "generation": 1}),
              ("evict", {"from": "suspect", "dp": 4, "step": 3,
                         "generation": 1}),
              ("reform", {"dp": 4, "step": 3, "generation": 1}),
              ("resume", {"from": "reform", "dp": 2, "step": 3,
                          "generation": 2}),
              ("running", {"from": "resume", "dp": 2, "step": 2,
                           "generation": 2})]
    spans = []
    for tr in (jtracing, ttracing):
        clock = iter(float(t) for t in range(100))
        tracer = tr.Tracer(clock=lambda: next(clock))

        class Sup:
            state = "running"
            listeners: list = []

        sup = Sup()
        ctx = tr.attach_supervisor(tracer, sup)
        assert ctx.trace_id == "t-gang"
        for state, info in script:
            for listener in sup.listeners:
                listener(state, info)
        spans.append(list(tracer.spans))
    assert spans[1] == spans[0]
    assert [s["attrs"]["to"] for s in spans[1]] == [s for s, _ in script]


def test_checkpoint_source_streams_a_jax_generation(tmp_path):
    """An adapter saved by JAX's ShardedCheckpointer loads into the
    port's pool through ``checkpoint_source``: one verified slice read
    per leaf, values bit-equal."""
    from k8s_dra_driver_tpu_torch.serving_lora import (AdapterManifest,
                                                       AdapterPool,
                                                       checkpoint_source,
                                                       make_adapter)
    adapter = make_adapter(TCFG, 4, seed=11)
    nested: dict = {}
    for name, arr in adapter.items():
        node = nested
        *head, last = name.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = arr
    jres.ShardedCheckpointer(tmp_path / "ckpt").save(3, nested, {})
    pool = AdapterPool(TCFG, 4, 2, device="cpu")
    ckpt = tres.ShardedCheckpointer(tmp_path / "ckpt")
    pool.register(AdapterManifest("a", 4, source=checkpoint_source(ckpt, 3)))
    slot = pool.acquire("a")
    assert ckpt.last_restore_stats["files_read"] == 1
    for i, layer in enumerate(pool.buffers):
        for j, tail in enumerate(("wq/A", "wq/B", "wo/A", "wo/B")):
            np.testing.assert_array_equal(
                layer[j][slot].numpy(), adapter[f"layers/{i}/{tail}"])
