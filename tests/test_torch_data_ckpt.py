"""Port data loader and checkpointer (k8s_dra_driver_tpu_torch/models/
data.py, checkpoint.py).

The loader is held against the JAX package's ``BatchLoader`` batch for
batch (exact: both are numpy over the same seed), across an epoch
boundary and after a ``state_dict`` round trip.  The checkpointer
mirrors ``tests/test_model_checkpoint.py`` where no mesh is needed:
resume continues the uninterrupted trajectory, retention, the newest
readable generation, strict explicit steps and the ``extra`` sidecar.
Training runs on the CPU at a small f32 size.
"""

import json
import os
import zlib

import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import data as jdata
from k8s_dra_driver_tpu_torch.models import data as tdata
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.checkpoint import (INTEGRITY_FORMAT,
                                                        ShardCorruption,
                                                        TrainCheckpointer)

CFG = tt.TransformerConfig(vocab=96, d_model=48, n_layers=2, n_heads=4,
                           n_kv_heads=2, d_head=12, d_ff=96, max_seq=32,
                           dtype=torch.float32)


def corpus(n=4096, vocab=128, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, n)


# -- token files and the loader --------------------------------------------

@pytest.mark.parametrize("vocab,dtype", [(128, np.uint16),
                                         (100_000, np.uint32)])
def test_token_file_is_the_jax_format(tmp_path, vocab, dtype):
    toks = corpus(n=512, vocab=vocab)
    ours = tdata.write_token_file(toks, tmp_path / "t.bin", vocab)
    theirs = jdata.write_token_file(toks, tmp_path / "j.bin", vocab)
    assert ours.read_bytes() == theirs.read_bytes()
    back = tdata.load_token_file(theirs, vocab)
    assert back.dtype == dtype
    np.testing.assert_array_equal(np.asarray(back), toks)


LOADERS = {
    "shuffled": dict(seed=3),
    "unshuffled": dict(shuffle=False),
    "stripe_1_of_2": dict(seed=5, stripe_index=1, stripe_count=2),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_batches_equal_jax_across_epochs_and_resume(name):
    """4 windows per epoch: 5 steps cross the epoch boundary; a loader
    restored from the state after step 3 yields JAX's steps 4-5."""
    toks = corpus(n=4 * 32 * 4 + 17)         # a ragged tail is dropped
    kw = dict(batch=4, seq_len=32, **LOADERS[name])
    ours, theirs = tdata.BatchLoader(toks, **kw), jdata.BatchLoader(toks,
                                                                    **kw)
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 4
    got = [next(ours) for _ in range(5)]
    want = [next(theirs) for _ in range(5)]
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert ours.state_dict() == theirs.state_dict() == {"epoch": 1,
                                                        "step": 1}
    again = tdata.BatchLoader(toks, **kw)
    fresh = tdata.BatchLoader(toks, **kw)
    for _ in range(3):
        next(fresh)
    again.load_state_dict(json.loads(json.dumps(fresh.state_dict())))
    for w in want[3:]:
        np.testing.assert_array_equal(next(again), w)


LOADER_ERRORS = {
    "small_corpus": (dict(tokens=np.zeros(40), batch=2, seq_len=32),
                     "need at least"),
    "degenerate": (dict(tokens=np.zeros(64), batch=0, seq_len=32),
                   "must be >= 1"),
    "stripe_index": (dict(tokens=np.zeros(256), batch=4, seq_len=32,
                          stripe_index=2, stripe_count=2), "stripe"),
    "stripe_count": (dict(tokens=np.zeros(256), batch=3, seq_len=32,
                          stripe_count=2), "does not stripe"),
}


@pytest.mark.parametrize("name", sorted(LOADER_ERRORS))
def test_loader_validation_matches_jax(name):
    kw, match = LOADER_ERRORS[name]
    with pytest.raises(ValueError, match=match) as jerr:
        jdata.BatchLoader(**kw)
    with pytest.raises(ValueError, match=match) as terr:
        tdata.BatchLoader(**kw)
    assert str(terr.value) == str(jerr.value)


def test_out_of_range_tokens_rejected(tmp_path):
    with pytest.raises(ValueError, match="out of range"):
        tdata.write_token_file([5, 200], tmp_path / "c.bin", vocab=128)


def test_local_rows_follow_the_process_group(monkeypatch):
    batch = np.arange(16).reshape(8, 2)
    np.testing.assert_array_equal(tdata.local_rows(batch), batch)
    monkeypatch.setattr(tdata.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdata.dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(tdata.dist, "get_rank", lambda: 2)
    np.testing.assert_array_equal(tdata.local_rows(batch), batch[4:6])
    with pytest.raises(ValueError, match="does not stripe"):
        tdata.local_rows(batch[:6])


# -- the checkpointer --------------------------------------------------------

def train_state(seed=0, cfg=CFG):
    step, init_state = tt.make_train_step(cfg, device="cpu")
    params, opt = init_state(torch.Generator().manual_seed(seed))
    return step, params, opt


def batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, (4, 16)).astype(np.int32)
            for _ in range(n)]


def snapshot(params, opt):
    out = [t.detach().clone() for _, t in tt.named_tensors(params)]
    state = opt.state_dict()["state"]
    for i in sorted(state):
        out += [torch.as_tensor(state[i][key]).clone()
                for key in sorted(state[i])]
    return out


def assert_same_state(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_resume_continues_exact_trajectory(tmp_path):
    step, params, opt = train_state()
    data = batches(5)
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    for b in data[:3]:
        params, opt, _ = step(params, opt, b)
    ckpt.save(3, params, opt, extra={"epoch": 0, "step": 3})
    saved = snapshot(params, opt)
    ref_losses = []
    for b in data[3:]:
        params, opt, loss = step(params, opt, b)
        ref_losses.append(float(loss))

    # "preemption": a fresh state from another seed, restored
    _, params2, opt2 = train_state(seed=9)
    params2, opt2, at = ckpt.restore(params2, opt2)
    assert at == 3
    assert_same_state(snapshot(params2, opt2), saved)
    assert ckpt.restore_extra() == {"epoch": 0, "step": 3}
    losses = []
    for b in data[3:]:
        params2, opt2, loss = step(params2, opt2, b)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    ckpt.close()


def test_latest_retention_and_integrity_sidecars(tmp_path):
    step, params, opt = train_state()
    ckpt = TrainCheckpointer(tmp_path / "ckpt", keep=2)
    for s, b in zip((1, 2, 3), batches(3)):
        params, opt, _ = step(params, opt, b)
        ckpt.save(s, params, opt, wait=(s != 3))
    assert ckpt.latest_step() == 3           # waits for the async save
    assert ckpt.all_steps() == [2, 3]
    integrity = tmp_path / "ckpt-integrity"
    assert sorted(p.name for p in integrity.iterdir()) == ["2.json",
                                                           "3.json"]
    side = json.loads((integrity / "3.json").read_text())
    assert side["format"] == INTEGRITY_FORMAT and side["step"] == 3
    assert sorted(side["files"]) == ["extra.json", "opt_state.pt",
                                     "params.pt"]
    for name, (crc, size) in side["files"].items():
        blob = (tmp_path / "ckpt" / "3" / name).read_bytes()
        assert (zlib.crc32(blob) & 0xFFFFFFFF, len(blob)) == (crc, size)
    _, _, at = ckpt.restore(params, opt)
    assert at == 3
    # a second save of a committed step returns and keeps the first
    # generation's bytes and extra, as the JAX checkpointer (orbax)
    # does on the same inputs
    step_dir = tmp_path / "ckpt" / "3"
    blobs = {p.name: p.read_bytes() for p in step_dir.iterdir()}
    first = snapshot(params, opt)
    _, params_x, opt_x = train_state(seed=5)
    ckpt.save(3, params_x, opt_x, extra={"epoch": 9, "step": 9})
    assert {p.name: p.read_bytes() for p in step_dir.iterdir()} == blobs
    _, params_r, opt_r = train_state(seed=6)
    ckpt.restore(params_r, opt_r, step=3)
    assert_same_state(snapshot(params_r, opt_r), first)
    assert ckpt.restore_extra(3) == {}

    from k8s_dra_driver_tpu.models import checkpoint as jckpt

    def host(tree):
        return {n.replace(".", "_"): t.detach().numpy().copy()
                for n, t in tt.named_tensors(tree)}

    jck = jckpt.TrainCheckpointer(tmp_path / "jax")
    m = {"m": np.zeros((4,), np.float32)}
    jck.save(3, host(params), m)
    jck.save(3, host(params_x), m, extra={"epoch": 9, "step": 9})
    got, _, at = jck.restore(host(params_r), m)
    assert at == 3
    assert jck.restore_extra(3) == ckpt.restore_extra(3)
    for name, t in tt.named_tensors(params_r):
        np.testing.assert_array_equal(np.asarray(got[name.replace(".", "_")]),
                                      t.detach().numpy())
    jck.close()
    ckpt.close()


def flip_byte(path, at=-100):
    data = bytearray(path.read_bytes())
    data[at] ^= 0xFF
    path.write_bytes(bytes(data))


def test_corrupt_newest_falls_back_and_explicit_step_is_strict(tmp_path):
    step, params, opt = train_state()
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    states = {}
    for s, b in zip((1, 2), batches(2)):
        params, opt, _ = step(params, opt, b)
        ckpt.save(s, params, opt)
        states[s] = snapshot(params, opt)
    flip_byte(tmp_path / "ckpt" / "2" / "params.pt")
    _, params2, opt2 = train_state(seed=4)
    with pytest.raises(ShardCorruption, match="checksum"):
        ckpt.restore(params2, opt2, step=2)
    params2, opt2, at = ckpt.restore(params2, opt2)
    assert at == 1
    assert_same_state(snapshot(params2, opt2), states[1])
    # a truncated file is named as such
    path = tmp_path / "ckpt" / "1" / "opt_state.pt"
    os.truncate(path, path.stat().st_size - 8)
    with pytest.raises(ShardCorruption, match="truncated"):
        ckpt.restore(params2, opt2, step=1)
    with pytest.raises(FileNotFoundError, match="no restorable"):
        ckpt.restore(params2, opt2)
    ckpt.close()


def test_torn_generations_are_skipped(tmp_path):
    """A write that never committed (a leftover temp directory) is no
    step; a generation without a sidecar whose files do not parse is
    skipped newest-first."""
    step, params, opt = train_state()
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    params, opt, _ = step(params, opt, batches(1)[0])
    ckpt.save(1, params, opt)
    (tmp_path / "ckpt" / ".tmp-2-abc").mkdir()
    (tmp_path / "ckpt" / "3").mkdir()
    (tmp_path / "ckpt" / "3" / "params.pt").write_bytes(b"torn")
    assert ckpt.all_steps() == [1, 3]
    _, _, at = ckpt.restore(params, opt)
    assert at == 1
    ckpt.close()


def test_restore_casts_to_the_targets_dtype(tmp_path):
    """Restore keeps each target tensor's device and dtype: an f32
    generation restored into a bf16 state holds the f32 values cast."""
    step, params, opt = train_state()
    params, opt, _ = step(params, opt, batches(1)[0])
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(1, params, opt)
    bf16 = tt.TransformerConfig(**{**CFG.__dict__,
                                   "dtype": torch.bfloat16})
    _, params2, opt2 = train_state(seed=2, cfg=bf16)
    params2, opt2, _ = ckpt.restore(params2, opt2)
    for (_, a), (_, b) in zip(tt.named_tensors(params2),
                              tt.named_tensors(params)):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.detach().to(torch.bfloat16))
    moments = opt2.state_dict()["state"][0]
    assert moments["exp_avg"].dtype == torch.bfloat16
    ckpt.close()


def test_restore_refuses_a_state_of_another_shape(tmp_path):
    step, params, opt = train_state()
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    ckpt.save(1, params, opt)
    wider = tt.TransformerConfig(**{**CFG.__dict__, "d_ff": 128})
    _, params2, opt2 = train_state(cfg=wider)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(params2, opt2, step=1)
    with pytest.raises(FileNotFoundError, match="no restorable"):
        ckpt.restore(params2, opt2)
    ckpt.close()


def test_missing_checkpoint_and_extra_sidecar(tmp_path):
    _, params, opt = train_state()
    ckpt = TrainCheckpointer(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(params, opt)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_extra()
    ckpt.save(1, params, opt)
    assert ckpt.restore_extra(1) == {}
    (tmp_path / "empty" / "1" / "extra.json").unlink()
    assert ckpt.restore_extra(1) == {}
    (tmp_path / "empty" / "1" / "extra.json").write_text("{garbage")
    with pytest.raises(ValueError):
        ckpt.restore_extra(1)
    ckpt.close()
