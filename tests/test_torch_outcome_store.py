"""Port durable outcome journal (k8s_dra_driver_tpu_torch/gateway/
outcome_store.py) against the JAX package's, on the CPU.

The scenarios of tests/test_outcome_store.py run on both packages
(parametrized by side): checksummed line framing with torn-line
discard, the writer's duplicate suppression and batched fsync, the
first-terminal-wins replay with conflicts surfaced, torn tails against
mid-file corruption.  Across the packages: the same entries give
line-equal segments, and a segment written by either replays to the
identical ``OutcomeView`` fold (terminals, duplicates, conflicts, torn,
corrupt, counts) in the other.  The two crash windows of the append
discipline (after flush, after fsync) are hit in a port subprocess
through the port's ``crashpoint`` armed by a fault plan, and both
packages' replays restore every terminal.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import pytest

from k8s_dra_driver_tpu.cluster import faults as jf
from k8s_dra_driver_tpu.gateway import outcome_store as jos
from k8s_dra_driver_tpu_torch.cluster import faults as tf
from k8s_dra_driver_tpu_torch.gateway import outcome_store as tos

pytestmark = pytest.mark.timeout_s(120)

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"jax": jos, "torch": tos}


def _entry(uid, status="finished", tokens=(1, 2, 3), **extra):
    e = {"uid": uid, "status": status, "tokens": list(tokens)}
    e.update(extra)
    return e


def fold(view) -> dict:
    return {"terminals": view.terminals, "duplicates": view.duplicates,
            "conflicts": view.conflicts, "torn": view.torn,
            "corrupt": view.corrupt, "counts": view.counts()}


@pytest.fixture(params=sorted(SIDES))
def side(request):
    return SIDES[request.param]


# -- line framing ------------------------------------------------------------

def test_line_framing_equal_and_torn_tolerant(side):
    e = _entry("u1", requeues=2, pump="pump0", tokens=[5, 6, 7])
    line = side._encode_line(e)
    assert line == jos._encode_line(e)
    assert side._decode_line(line) == e
    torn = line[:-4] + ("X" if line[-4] != "X" else "Y") + line[-3:]
    assert side._decode_line(torn) is None
    for cut in (3, 9, len(line) // 2, len(line) - 2):
        assert side._decode_line(line[:cut]) is None
    payload = json.dumps({"status": "finished"}, sort_keys=True,
                         separators=(",", ":"))
    crc = zlib.crc32(payload.encode()) & 0xFFFFFFFF
    assert side._decode_line(f"{crc:08x} {payload}\n") is None


# -- writer ------------------------------------------------------------------

def test_writer_dedups_batches_and_reopens(side, tmp_path):
    store = side.OutcomeStore(tmp_path)
    w = store.writer("pump0")
    assert w.record(_entry("u1")) is True
    assert w.record(_entry("u1")) is False
    assert w.record_many([_entry(f"u{i}") for i in range(5)]) == 4
    assert len(w.fsync_ms) == 2          # one commit a batch
    w.close()
    w2 = store.writer("pump0")           # the recovered pump
    assert "u1" in w2.seen and w2.record(_entry("u1")) is False
    w2.close()
    view = store.replay()
    assert set(view.terminals) == {f"u{i}" for i in range(5)}
    assert view.duplicates == 0
    with pytest.raises(ValueError):
        store.writer("../evil")
    with pytest.raises(ValueError):
        store.writer(".hidden")


def test_reopen_after_torn_tail_never_concatenates(side, tmp_path):
    store = side.OutcomeStore(tmp_path)
    w = store.writer("pump0")
    w.record(_entry("u1"))
    w.close()
    path = store.segments()[0]
    path.write_text(path.read_text() + side._encode_line(_entry("u2"))[:-7])
    w2 = store.writer("pump0")
    assert "u1" in w2.seen and "u2" not in w2.seen
    assert w2.record(_entry("u3")) is True
    w2.close()
    view = store.replay()
    assert set(view.terminals) == {"u1", "u3"}
    assert view.torn == 0 and view.corrupt == 0


# -- replay ------------------------------------------------------------------

def write_scenario(side, root):
    """Two pumps' segments: a benign re-run, a disagreeing re-run, a
    shed, a torn tail and one damaged line mid-file."""
    store = side.OutcomeStore(root)
    a = store.writer("pump0")
    a.record_many([_entry("u1", tokens=[1, 2], pump="pump0"),
                   _entry("u2", tokens=[4], pump="pump0"),
                   _entry("u3", status="shed_expired", tokens=())])
    a.record(_entry("u4", tokens=[9], pump="pump0"))
    a.close()
    b = store.writer("pump1")
    b.record_many([_entry("u1", tokens=[1, 2], pump="pump1"),
                   _entry("u2", tokens=[7, 7], pump="pump1"),
                   _entry("u5", pump="pump1")])
    b.close()
    seg0, seg1 = store.segments()
    lines = seg0.read_text().splitlines()
    lines[3] = lines[3][:-3] + "zzz"      # u4 damaged mid-file
    seg0.write_text("\n".join(lines + [lines[0]]) + "\n")
    seg1.write_text(seg1.read_text()
                    + side._encode_line(_entry("u6"))[:-7])
    return store


def test_replay_first_wins_conflicts_torn_corrupt(side, tmp_path):
    view = write_scenario(side, tmp_path).replay()
    assert view.terminals["u1"]["pump"] == "pump0"
    assert view.terminals["u2"]["tokens"] == [4]
    assert view.conflicts == ["u2"]
    assert view.duplicates == 2          # u1 again, and pump1's u1
    assert view.torn == 1 and view.corrupt == 1
    assert set(view.terminals) == {"u1", "u2", "u3", "u5"}
    assert view.counts() == {"finished": 3, "shed_expired": 1}
    store = side.OutcomeStore(tmp_path)
    assert set(store.replay(segment="pump1").terminals) == {"u1", "u2",
                                                             "u5"}
    assert store.replay(segment="ghost").terminals == {}


def test_segments_line_equal_across_packages(tmp_path):
    """The same records through each package's writer give the same
    segment files byte for byte."""
    entries = [_entry(f"u{i}", tokens=range(i), requeues=i % 2,
                      pump="pump0", n_prompt=3) for i in range(6)]
    for name, mod in SIDES.items():
        w = mod.OutcomeStore(tmp_path / name).writer("pump0")
        w.record_many(entries[:4])
        w.record(entries[4])
        w.record_many(entries[3:])
        w.close()
    assert ((tmp_path / "torch" / "pump0.jsonl").read_bytes()
            == (tmp_path / "jax" / "pump0.jsonl").read_bytes())


@pytest.mark.parametrize("writer", sorted(SIDES))
def test_replay_identical_across_packages(tmp_path, writer):
    """A store written (and damaged) through one package folds to the
    identical view in both."""
    write_scenario(SIDES[writer], tmp_path)
    views = {name: fold(mod.OutcomeStore(tmp_path).replay())
             for name, mod in SIDES.items()}
    assert views["torch"] == views["jax"]
    for seg in ("pump0", "pump1"):
        assert (fold(tos.OutcomeStore(tmp_path).replay(segment=seg))
                == fold(jos.OutcomeStore(tmp_path).replay(segment=seg)))


# -- crash windows (port subprocess, port crashpoint) ----------------------

_CRASH_CHILD = textwrap.dedent("""
    import sys
    from k8s_dra_driver_tpu_torch.cluster import faults
    from k8s_dra_driver_tpu_torch.cluster.faults import FaultPlan, FaultRule
    from k8s_dra_driver_tpu_torch.gateway.outcome_store import OutcomeStore
    store = OutcomeStore(sys.argv[1])
    w = store.writer("pump0")
    w.record({"uid": "u0", "status": "finished", "tokens": [7]})
    faults.install_process_plan(FaultPlan([FaultRule(
        verb=sys.argv[2], times=1, error="crash")]))
    w.record_many([
        {"uid": "u1", "status": "finished", "tokens": [1, 2]},
        {"uid": "u2", "status": "finished", "tokens": [3]}])
    raise SystemExit("crashpoint never fired")
""")


def _crash_at(point, root):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _CRASH_CHILD, str(root), point],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == tf.CRASH_EXIT_CODE == jf.CRASH_EXIT_CODE, \
        proc.stderr


@pytest.mark.parametrize("point", [tf.CRASH_OUTCOME_APPENDED,
                                   tf.CRASH_OUTCOME_COMMITTED])
def test_death_in_either_window_keeps_every_terminal(tmp_path, point):
    """Dying after the flush or after the fsync: every terminal
    survives the process, in both packages' replays, and a recovered
    writer plus a re-run elsewhere never double a terminal."""
    _crash_at(point, tmp_path)
    for mod in (tos, jos):
        view = mod.OutcomeStore(tmp_path).replay()
        assert set(view.terminals) == {"u0", "u1", "u2"}
        assert view.conflicts == [] and view.corrupt == 0
    store = tos.OutcomeStore(tmp_path)
    w = store.writer("pump0")                  # recovered in place
    assert w.record(_entry("u1", tokens=[1, 2])) is False
    w.close()
    w2 = store.writer("pump1")                 # re-run elsewhere
    assert w2.record(_entry("u2", tokens=[3])) is True
    w2.close()
    views = [fold(mod.OutcomeStore(tmp_path).replay()) for mod in (tos, jos)]
    assert views[0] == views[1]
    assert len(views[0]["terminals"]) == 3
    assert views[0]["duplicates"] == 1 and views[0]["conflicts"] == []
