"""The port's workload-side coordination (the twin of
tests/test_coordclient.py): the gate, the daemon's enforcer and HBM
supervision, stale eviction, the timeshare gate and the schedule math,
with the port's gate as the child wrapper; then the port held to the JAX
package: equal schedule math, registrations scheduled across packages
both ways with equal ``schedule.json`` and ``status.json``, the NVIDIA
timeshare lock per GPU UUID (where the JAX gate locks nothing), and the
device-memory budget as the CUDA allocator's option."""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from k8s_dra_driver_tpu.cmd.coordinatord import Coordinator as JaxCoordinator
from k8s_dra_driver_tpu.coordclient import CoordinatorClient as JaxClient
from k8s_dra_driver_tpu.coordclient import schedule as jax_sched
from k8s_dra_driver_tpu.coordclient.gate import TimeshareGate as JaxGate
from k8s_dra_driver_tpu_torch.cmd.coordinatord import Coordinator
from k8s_dra_driver_tpu_torch.coordclient import CoordinatorClient
from k8s_dra_driver_tpu_torch.coordclient import schedule as sched
from k8s_dra_driver_tpu_torch.coordclient.client import (
    ENV_ALLOC_CONF, hbm_fraction, merge_alloc_conf)
from k8s_dra_driver_tpu_torch.coordclient.gate import (TimeshareGate,
                                                       _run_coordinated)

REPO = Path(__file__).parent.parent
GATE = "k8s_dra_driver_tpu_torch.coordclient.gate"

# A tick-recorder workload: appends one wall-clock-ms line per ~4ms of
# *running* time.  While SIGSTOPped it records nothing, so its output
# is a direct measurement of when it was allowed to compute.
TICKER = """
import sys, time
path, dur = sys.argv[1], float(sys.argv[2])
end = time.time() + dur
f = open(path, "w", buffering=1)
while time.time() < end:
    f.write(f"{time.time()*1000:.3f}\\n")
    time.sleep(0.004)
"""


def read_ticks(path: Path) -> list[float]:
    if not path.exists():
        return []
    return [float(line) for line in path.read_text().splitlines() if line]


def proc_state(pid: int) -> str:
    """Kernel scheduling state letter (R/S/T/...) from /proc."""
    stat = Path(f"/proc/{pid}/stat").read_text()
    return stat.rsplit(")", 1)[1].split()[0]


def wait_for_state(pid: int, want: set[str], timeout: float = 5.0) -> str:
    deadline = time.time() + timeout
    state = "?"
    while time.time() < deadline:
        try:
            state = proc_state(pid)
        except OSError:
            return "gone"
        if state in want:
            return state
        time.sleep(0.01)
    return state


class _GateArgs:
    """argparse.Namespace stand-in for _run_coordinated."""

    def __init__(self, coordination_dir, name):
        self.coordination_dir = str(coordination_dir)
        self.name = name
        self.weight = 1.0
        self.ready_timeout = 30.0


def serve(coord, cdir):
    stop = threading.Event()
    t = threading.Thread(target=coord.serve, args=(0.05, stop), daemon=True)
    t.start()
    deadline = time.time() + 10
    while not (cdir / "ready").exists():
        assert time.time() < deadline, "daemon never ready"
        time.sleep(0.01)
    return t, stop


@pytest.fixture
def daemon(tmp_path):
    """A live port coordinator over tmp_path/coord: 240ms cycle,
    two-worker claims split it 120ms/120ms."""
    coord = Coordinator(tmp_path / "coord", duty_cycle_percent=100,
                        preemption_ms=240, hbm_limits={},
                        visible_chips=[0], policy_dir=None)
    t, stop = serve(coord, tmp_path / "coord")
    yield coord, tmp_path / "coord"
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive()


def two_worker_schedule(cdir, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        snap = json.loads((cdir / "schedule.json").read_text())
        if len(snap.get("slots", [])) == 2:
            return snap
        time.sleep(0.01)
    return None


class TestAlternation:
    def test_two_workloads_alternate_on_schedule(self, daemon, tmp_path):
        _, cdir = daemon
        ticks_a = tmp_path / "a.ticks"
        ticks_b = tmp_path / "b.ticks"
        results = {}

        def run(name, out):
            cmd = [sys.executable, "-c", TICKER, str(out), "2.2"]
            results[name] = _run_coordinated(_GateArgs(cdir, name), cmd)

        ta = threading.Thread(target=run, args=("wa", ticks_a))
        tb = threading.Thread(target=run, args=("wb", ticks_b))
        ta.start()
        tb.start()
        schedule = two_worker_schedule(cdir)
        ta.join(timeout=60)
        tb.join(timeout=60)
        assert not ta.is_alive() and not tb.is_alive()
        assert results == {"wa": 0, "wb": 0}
        assert schedule is not None, "two-worker schedule never published"
        slots = {s["worker"]: s for s in schedule["slots"]}
        assert slots["wa"]["dutyCyclePercent"] == 50
        assert abs(slots["wa"]["windowMs"] - 120) < 1
        assert abs(slots["wb"]["windowMs"] - 120) < 1

        a, b = read_ticks(ticks_a), read_ticks(ticks_b)
        assert len(a) > 20 and len(b) > 20
        share = len(a) / (len(a) + len(b))
        assert 0.25 < share < 0.75, f"wa got {share:.0%} of ticks"
        for name, ticks in (("wa", a), ("wb", b)):
            inside = sum(1 for t in ticks
                         if sched.active_worker(schedule, t) == name)
            frac = inside / len(ticks)
            assert frac > 0.7, f"{name}: only {frac:.0%} in-window"
        merged = sorted([(t, "wa") for t in a] + [(t, "wb") for t in b])
        switches = sum(1 for i in range(1, len(merged))
                       if merged[i][1] != merged[i - 1][1])
        assert switches >= 4, f"only {switches} alternations"

    def test_forked_workload_cannot_escape_the_gate(self, daemon, tmp_path):
        _, cdir = daemon
        ticks_f = tmp_path / "f.ticks"
        ticks_p = tmp_path / "p.ticks"
        results = {}

        def run(name, cmd):
            results[name] = _run_coordinated(_GateArgs(cdir, name), cmd)

        script = tmp_path / "ticker.py"
        script.write_text(TICKER)
        forked_cmd = ["sh", "-c",
                      f"{sys.executable} {script} {ticks_f} 2.2"]
        plain_cmd = [sys.executable, str(script), str(ticks_p), "2.2"]
        tf = threading.Thread(target=run, args=("wf", forked_cmd))
        tp = threading.Thread(target=run, args=("wp", plain_cmd))
        tf.start()
        tp.start()
        schedule = two_worker_schedule(cdir)
        tf.join(timeout=60)
        tp.join(timeout=60)
        assert results == {"wf": 0, "wp": 0}
        assert schedule is not None
        f = read_ticks(ticks_f)
        assert len(f) > 20, "forked grandchild never ran"
        inside = sum(1 for t in f
                     if sched.active_worker(schedule, t) == "wf")
        frac = inside / len(f)
        assert frac > 0.7, \
            f"forked workload escaped the gate: {frac:.0%} in-window"

    def test_gate_releases_child_on_daemon_loss(self, daemon, tmp_path):
        _, cdir = daemon
        out = tmp_path / "c.ticks"
        cmd = [sys.executable, "-c", TICKER, str(out), "0.4"]
        rc = _run_coordinated(_GateArgs(cdir, "solo"), cmd)
        assert rc == 0
        assert len(read_ticks(out)) > 5


def hbm_coord(tmp_path, **kw):
    return Coordinator(tmp_path / "c", duty_cycle_percent=100,
                       preemption_ms=0,
                       hbm_limits=kw.pop("hbm_limits", {"tpu-abc": 1 << 30}),
                       visible_chips=[0], policy_dir=None, **kw)


def sleeper():
    return subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])


class TestHbmSupervision:
    def test_violation_detected_and_reported(self, tmp_path):
        coord = hbm_coord(tmp_path)
        coord.start()
        client = CoordinatorClient(tmp_path / "c", name="greedy")
        client.register()
        client.heartbeat(hbm_bytes_in_use=2 << 30)
        coord.step()
        status = json.loads((tmp_path / "c/status.json").read_text())
        assert status["violations"] == [{
            "worker": "greedy", "usedBytes": 2 << 30,
            "limitBytes": 1 << 30, "action": "report"}]
        client.heartbeat(hbm_bytes_in_use=1 << 29)
        coord.step()
        status = json.loads((tmp_path / "c/status.json").read_text())
        assert status["violations"] == []

    def test_per_worker_limit_beats_claim_limit(self, tmp_path):
        coord = hbm_coord(tmp_path, hbm_limits={"tpu-abc": 8 << 30})
        coord.start()
        client = CoordinatorClient(tmp_path / "c", name="w")
        client.register(hbm_limit_bytes=1 << 30)
        client.heartbeat(hbm_bytes_in_use=2 << 30)
        coord.step()
        status = json.loads((tmp_path / "c/status.json").read_text())
        assert status["violations"][0]["limitBytes"] == 1 << 30

    def test_terminate_action_kills_violator(self, tmp_path):
        coord = hbm_coord(tmp_path, enforce=True, hbm_action="terminate")
        coord.start()
        proc = sleeper()
        try:
            client = CoordinatorClient(tmp_path / "c", name="greedy")
            client.register(pid=proc.pid)
            client.heartbeat(hbm_bytes_in_use=2 << 30)
            coord.step()
            assert proc.wait(timeout=10) == -15      # SIGTERM
            coord.step()
            assert coord.violations[0]["worker"] == "greedy"
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def test_restarted_violator_is_enforced_again(self, tmp_path):
        coord = hbm_coord(tmp_path, enforce=True, hbm_action="terminate")
        coord.start()
        for _ in range(2):
            proc = sleeper()
            try:
                client = CoordinatorClient(tmp_path / "c", name="greedy")
                client.register(pid=proc.pid)
                client.heartbeat(hbm_bytes_in_use=2 << 30)
                coord.step()
                assert proc.wait(timeout=10) == -15
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

    def test_report_action_never_signals(self, tmp_path):
        coord = hbm_coord(tmp_path, enforce=True, hbm_action="report")
        coord.start()
        proc = sleeper()
        try:
            client = CoordinatorClient(tmp_path / "c", name="greedy")
            client.register(pid=proc.pid)
            client.heartbeat(hbm_bytes_in_use=2 << 30)
            coord.step()
            time.sleep(0.1)
            assert proc.poll() is None
            assert coord.violations[0]["action"] == "report"
        finally:
            proc.kill()
            proc.wait()


class TestEnforceTick:
    def test_pids_follow_the_schedule(self, tmp_path):
        fake_now = {"ms": 0.0}
        coord = Coordinator(tmp_path / "c", duty_cycle_percent=100,
                            preemption_ms=200, hbm_limits={},
                            visible_chips=[0], policy_dir=None,
                            enforce=True,
                            now_ms=lambda: fake_now["ms"])
        coord.start()
        procs = [sleeper() for _ in range(2)]
        try:
            for i, p in enumerate(procs):
                CoordinatorClient(tmp_path / "c",
                                  name=f"w{i}").register(pid=p.pid)
            coord.step()
            fake_now["ms"] = coord.epoch_ms + 50
            coord.enforce_tick()
            assert wait_for_state(procs[0].pid, {"S", "R"}) in ("S", "R")
            assert wait_for_state(procs[1].pid, {"T"}) == "T"
            fake_now["ms"] = coord.epoch_ms + 150
            coord.enforce_tick()
            assert wait_for_state(procs[0].pid, {"T"}) == "T"
            assert wait_for_state(procs[1].pid, {"S", "R"}) in ("S", "R")
            coord.release_all()
            assert wait_for_state(procs[0].pid, {"S", "R"}) in ("S", "R")
        finally:
            for p in procs:
                p.kill()
                p.wait()

    def test_release_all_resumes_whole_group(self, tmp_path):
        fake_now = {"ms": 1_000_000.0}
        coord = Coordinator(tmp_path / "c", duty_cycle_percent=100,
                            preemption_ms=200, hbm_limits={},
                            visible_chips=[0], policy_dir=None,
                            enforce=True,
                            now_ms=lambda: fake_now["ms"])
        coord.start()
        pidfile = tmp_path / "grandchild.pid"
        leader = subprocess.Popen(
            ["sh", "-c",
             f"{sys.executable} -c 'import time, os, sys; "
             f"open(sys.argv[1], \"w\").write(str(os.getpid())); "
             f"time.sleep(60)' {pidfile}"],
            start_new_session=True)
        try:
            deadline = time.time() + 10
            while not pidfile.exists() or not pidfile.read_text():
                assert time.time() < deadline, "grandchild never started"
                time.sleep(0.01)
            grandchild = int(pidfile.read_text())
            client = CoordinatorClient(tmp_path / "c", name="w0",
                                       now_ms=lambda: fake_now["ms"])
            client.register(pid=leader.pid, pid_is_group=True)
            CoordinatorClient(tmp_path / "c", name="w1",
                              now_ms=lambda: fake_now["ms"]).register(
                pid=9999999)
            coord.step()
            fake_now["ms"] = coord.epoch_ms + 150
            coord.enforce_tick()
            assert wait_for_state(leader.pid, {"T"}) == "T"
            assert wait_for_state(grandchild, {"T"}) == "T"
            coord.release_all()
            assert wait_for_state(leader.pid, {"S", "R"}) in ("S", "R")
            assert wait_for_state(grandchild, {"S", "R"}) in ("S", "R")
        finally:
            try:
                os.killpg(leader.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                leader.kill()
            leader.wait()

    def test_serve_with_enforce_releases_on_stop(self, tmp_path):
        coord = Coordinator(tmp_path / "c", duty_cycle_percent=100,
                            preemption_ms=100, hbm_limits={},
                            visible_chips=[0], policy_dir=None,
                            enforce=True)
        proc = sleeper()
        stop = threading.Event()
        t = threading.Thread(target=coord.serve, args=(0.05, stop),
                             daemon=True)
        try:
            t.start()
            deadline = time.time() + 10
            while not (tmp_path / "c/ready").exists():
                assert time.time() < deadline
                time.sleep(0.01)
            CoordinatorClient(tmp_path / "c", name="w0").register(
                pid=proc.pid)
            CoordinatorClient(tmp_path / "c", name="w1").register(
                pid=9999999)
            deadline = time.time() + 10
            while proc_state(proc.pid) != "T":
                assert time.time() < deadline, "enforcer never stopped w0"
                time.sleep(0.005)
            stop.set()
            t.join(timeout=10)
            assert not t.is_alive()
            assert wait_for_state(proc.pid, {"S", "R"}) in ("S", "R")
        finally:
            stop.set()
            proc.kill()
            proc.wait()


class TestStaleEviction:
    def test_silent_worker_evicted_and_unfrozen(self, tmp_path):
        fake_now = {"ms": 1_000_000.0}
        coord = Coordinator(tmp_path / "c", duty_cycle_percent=100,
                            preemption_ms=100, hbm_limits={},
                            visible_chips=[0], policy_dir=None,
                            enforce=True, stale_after_s=5.0,
                            now_ms=lambda: fake_now["ms"])
        coord.start()
        proc = sleeper()
        try:
            client = CoordinatorClient(tmp_path / "c", name="dead",
                                       now_ms=lambda: fake_now["ms"])
            client.register(pid=proc.pid)
            CoordinatorClient(tmp_path / "c", name="live",
                              now_ms=lambda: fake_now["ms"]).register(
                pid=9999999)
            coord.step()
            assert [w["name"] for w in coord._workers_cache] == \
                ["dead", "live"]
            fake_now["ms"] = coord.epoch_ms + 75
            coord.enforce_tick()
            assert wait_for_state(proc.pid, {"T"}) == "T"
            fake_now["ms"] += 6000
            coord.step()
            assert [w["name"] for w in coord._workers_cache] == []
            assert wait_for_state(proc.pid, {"S", "R"}) in ("S", "R")
            assert not (tmp_path / "c/ctl/dead.json").exists()
        finally:
            proc.kill()
            proc.wait()

    def test_heartbeating_worker_survives(self, tmp_path):
        fake_now = {"ms": 1_000_000.0}
        coord = Coordinator(tmp_path / "c", duty_cycle_percent=100,
                            preemption_ms=0, hbm_limits={},
                            visible_chips=[0], policy_dir=None,
                            stale_after_s=5.0,
                            now_ms=lambda: fake_now["ms"])
        coord.start()
        client = CoordinatorClient(tmp_path / "c", name="w",
                                   now_ms=lambda: fake_now["ms"])
        client.register()
        for _ in range(4):
            fake_now["ms"] += 3000
            client.heartbeat()
            coord.step()
            assert [w["name"] for w in coord._workers_cache] == ["w"]

    def test_wait_scheduled_resurrects_evicted_registration(
            self, daemon, tmp_path):
        _, cdir = daemon
        client = CoordinatorClient(cdir, name="lazarus")
        client.register()
        (cdir / "ctl/lazarus.json").unlink()
        client._last_heartbeat_ms = 0.0   # due for a heartbeat now
        schedule = client.wait_scheduled(timeout_s=10)
        assert any(s["worker"] == "lazarus" for s in schedule["slots"])

    def test_registration_without_timestamp_not_evicted(self, tmp_path):
        coord = Coordinator(tmp_path / "c", duty_cycle_percent=100,
                            preemption_ms=0, hbm_limits={},
                            visible_chips=[0], policy_dir=None,
                            stale_after_s=5.0)
        coord.start()
        (tmp_path / "c/ctl/manual.json").write_text(json.dumps({"pid": 7}))
        coord.step()
        assert [w["name"] for w in coord._workers_cache] == ["manual"]


def held_quanta(gate_of, duration_s=0.6):
    """Two threads contending through their own gates; each one's held
    quanta as (start, end) pairs."""
    intervals: dict[str, list[tuple[float, float]]] = {"a": [], "b": []}

    def contend(name):
        gate = gate_of()
        for deadline in gate.turns(duration_s=duration_s):
            start = time.time()
            while time.time() < deadline:
                time.sleep(0.002)
            intervals[name].append((start, time.time()))

    threads = [threading.Thread(target=contend, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return intervals


def assert_disjoint(intervals):
    assert len(intervals["a"]) >= 2 and len(intervals["b"]) >= 2
    for s1, e1 in intervals["a"]:
        for s2, e2 in intervals["b"]:
            assert e1 <= s2 or e2 <= s1, \
                f"quanta overlap: a=({s1},{e1}) b=({s2},{e2})"


class TestTimeshareGate:
    def test_mutual_exclusion_is_kernel_enforced(self, tmp_path):
        assert_disjoint(held_quanta(
            lambda: TimeshareGate(tmp_path / "ts", chips=[0],
                                  quantum_ms=30)))

    def test_multichip_claim_holds_all_its_locks(self, tmp_path):
        gate = TimeshareGate(tmp_path / "ts", chips=[0, 1], quantum_ms=20)
        gate.acquire()
        try:
            assert (tmp_path / "ts/chip0.lock").exists()
            assert (tmp_path / "ts/chip1.lock").exists()
        finally:
            gate.release()

    def test_from_env_requires_opt_in(self, tmp_path):
        assert TimeshareGate.from_env({}) is None
        assert TimeshareGate.from_env(
            {"TPU_TIMESHARE_DIR": str(tmp_path)}) is None      # no quantum
        gate = TimeshareGate.from_env({
            "TPU_TIMESHARE_DIR": str(tmp_path),
            "TPU_RUNTIME_PREEMPTION_MS": "50",
            "TPU_VISIBLE_CHIPS": "0,2"})
        assert gate is not None
        assert gate.chips == [0, 2]
        assert gate.cards == []
        assert gate.quantum_ms == 50


class TestScheduleMath:
    def test_windows_split_by_weight(self):
        wins = sched.compute_windows(
            [{"name": "a", "weight": 3}, {"name": "b", "weight": 1}],
            duty_cycle_percent=80, cycle_ms=100)
        assert wins[0].worker == "a" and wins[0].window_ms == 60
        assert wins[1].worker == "b" and wins[1].window_ms == 20
        assert wins[1].offset_ms == 60
        schedule = {"cycleMs": 100, "epochMs": 0, "slots": [
            {"worker": w.worker, "offsetMs": w.offset_ms,
             "windowMs": w.window_ms} for w in wins]}
        assert sched.active_worker(schedule, 30) == "a"
        assert sched.active_worker(schedule, 70) == "b"
        assert sched.active_worker(schedule, 90) is None

    def test_ms_until_and_left(self):
        schedule = {"cycleMs": 100, "epochMs": 0, "slots": [
            {"worker": "a", "offsetMs": 0, "windowMs": 40},
            {"worker": "b", "offsetMs": 40, "windowMs": 40}]}
        assert sched.ms_until_turn(schedule, "a", 10) == 0.0
        assert sched.ms_left_in_turn(schedule, "a", 10) == 30
        assert sched.ms_until_turn(schedule, "b", 10) == 30
        assert sched.ms_until_turn(schedule, "a", 90) == 10
        assert sched.ms_until_turn(schedule, "absent", 0) is None
        assert sched.ms_left_in_turn(schedule, "b", 10) == 0.0

    def test_zero_weight_gets_no_window(self):
        wins = sched.compute_windows(
            [{"name": "a", "weight": 0}, {"name": "b"}],
            duty_cycle_percent=100, cycle_ms=100)
        assert wins[0].window_ms == 0
        assert wins[1].window_ms == 100

    def test_malformed_weight_defaults_to_one(self):
        wins = sched.compute_windows(
            [{"name": "evil", "weight": "oops"},
             {"name": "list", "weight": [1, 2]},
             {"name": "b", "weight": 1}],
            duty_cycle_percent=100, cycle_ms=90)
        assert [w.window_ms for w in wins] == [30, 30, 30]


def run_gate(args, env=None, **kw):
    return subprocess.run([sys.executable, "-m", GATE, *args],
                          cwd=REPO, env=env, **kw)


class TestGateCli:
    def test_exec_unshared_passthrough(self, tmp_path):
        out = tmp_path / "out"
        rc = run_gate(
            ["exec", "--", sys.executable, "-c",
             f"open({str(out)!r}, 'w').write('ran')"],
            env={k: v for k, v in os.environ.items()
                 if k not in ("TPU_COORDINATOR_DIR", "TPU_TIMESHARE_DIR")}
        ).returncode
        assert rc == 0
        assert out.read_text() == "ran"

    def test_status_against_live_daemon(self, daemon):
        _, cdir = daemon
        res = run_gate(["status", "--coordination-dir", str(cdir),
                        "--name", "x"], capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        payload = json.loads(res.stdout)
        assert payload["daemonReady"] is True
        assert payload["schedule"]["cycleMs"] == 240


# -- the port held to the JAX package ------------------------------------


def random_schedule(rng):
    workers = [{"name": f"w{i}", "weight": rng.choice(
        [0, 1, 2, 3, 0.5, "x", None, True])} for i in range(rng.randint(0, 5))]
    duty = rng.choice([0, 1, 37, 50, 80, 100, 140])
    cycle = rng.choice([1, 20, 100, 240, 1000])
    return workers, duty, cycle


class TestScheduleEqualsJax:
    @pytest.mark.parametrize("seed", range(4))
    def test_windows_and_turns_equal(self, seed):
        rng = random.Random(seed)
        for _ in range(50):
            workers, duty, cycle = random_schedule(rng)
            wins = sched.compute_windows(workers, duty, cycle)
            assert [(w.worker, w.offset_ms, w.window_ms) for w in wins] == \
                [(w.worker, w.offset_ms, w.window_ms) for w in
                 jax_sched.compute_windows(workers, duty, cycle)]
            schedule = {"cycleMs": cycle, "epochMs": rng.uniform(0, 1e6),
                        "slots": [{"worker": w.worker,
                                   "offsetMs": w.offset_ms,
                                   "windowMs": w.window_ms} for w in wins]}
            for _ in range(20):
                now = rng.uniform(0, 3e6)
                assert sched.active_worker(schedule, now) == \
                    jax_sched.active_worker(schedule, now)
                for w in workers + [{"name": "absent"}]:
                    name = w["name"]
                    assert sched.ms_until_turn(schedule, name, now) == \
                        jax_sched.ms_until_turn(schedule, name, now)
                    assert sched.ms_left_in_turn(schedule, name, now) == \
                        jax_sched.ms_left_in_turn(schedule, name, now)
        assert sched.cycle_ms_for(0) == jax_sched.cycle_ms_for(0) == \
            sched.DEFAULT_CYCLE_MS
        assert sched.cycle_ms_for(75) == jax_sched.cycle_ms_for(75)


def comparable(cdir):
    """schedule.json and status.json less the daemon's pid and clock."""
    schedule = json.loads((cdir / "schedule.json").read_text())
    status = json.loads((cdir / "status.json").read_text())
    for key in ("pid", "updatedAt"):
        status.pop(key)
    return schedule, status


class TestAcrossPackages:
    """Registrations, policy files and a clock fed to both daemons give
    equal files; a worker of either package is scheduled by either
    daemon."""

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_both_daemons_publish_equal_files(self, tmp_path, writer):
        clock = {"ms": 1_000_000.0}
        policy = tmp_path / "policy"
        policy.mkdir()
        (policy / "chip1.json").write_text(json.dumps({"preemptionMs": 50}))
        daemons = {}
        for name, cls in (("jax", JaxCoordinator), ("port", Coordinator)):
            daemons[name] = cls(
                tmp_path / name, duty_cycle_percent=80, preemption_ms=20,
                hbm_limits={"GPU-a": 1 << 30}, visible_chips=[0, 1],
                policy_dir=policy, stale_after_s=5.0,
                now_ms=lambda: clock["ms"])
            daemons[name].start()
        client_cls = JaxClient if writer == "jax" else CoordinatorClient
        for name in daemons:
            w = client_cls(tmp_path / name, name="w0", weight=3.0,
                           now_ms=lambda: clock["ms"])
            w.register(pid=os.getpid(), pid_is_group=True)
            client_cls(tmp_path / name, name="w1",
                       now_ms=lambda: clock["ms"]).register(
                hbm_limit_bytes=1 << 20)
            w.heartbeat(hbm_bytes_in_use=2 << 30)
            client_cls(tmp_path / name, name="old",
                       now_ms=lambda: clock["ms"] - 9000).register()
        for _ in range(2):
            for d in daemons.values():
                d.step()
            assert comparable(tmp_path / "jax") == \
                comparable(tmp_path / "port")
            clock["ms"] += 1000
        schedule, status = comparable(tmp_path / "port")
        assert [s["worker"] for s in schedule["slots"]] == ["w0", "w1"]
        assert schedule["preemptionMs"] == 50
        assert status["violations"][0]["worker"] == "w0"

    @pytest.mark.parametrize("daemon_pkg", ["jax", "port"])
    def test_worker_of_the_other_package_is_scheduled(self, tmp_path,
                                                      daemon_pkg):
        cls = JaxCoordinator if daemon_pkg == "jax" else Coordinator
        client_cls = CoordinatorClient if daemon_pkg == "jax" else JaxClient
        coord = cls(tmp_path / "c", duty_cycle_percent=100,
                    preemption_ms=100, hbm_limits={}, visible_chips=[0],
                    policy_dir=None)
        t, stop = serve(coord, tmp_path / "c")
        try:
            client = client_cls(tmp_path / "c", name="other")
            client.wait_ready(10)
            client.register()
            schedule = client.wait_scheduled(10)
            assert [s["worker"] for s in schedule["slots"]] == ["other"]
            assert client.wait_turn(10) > 0
            client.unregister()
        finally:
            stop.set()
            t.join(timeout=10)
        assert not t.is_alive()

    def test_port_gate_under_the_jax_daemon(self, tmp_path):
        coord = JaxCoordinator(tmp_path / "c", duty_cycle_percent=100,
                               preemption_ms=100, hbm_limits={},
                               visible_chips=[0], policy_dir=None)
        t, stop = serve(coord, tmp_path / "c")
        try:
            out = tmp_path / "ticks"
            rc = _run_coordinated(
                _GateArgs(tmp_path / "c", "ported"),
                [sys.executable, "-c", TICKER, str(out), "0.3"])
            assert rc == 0
            assert len(read_ticks(out)) > 5
            assert not (tmp_path / "c/ctl/ported.json").exists()
        finally:
            stop.set()
            t.join(timeout=10)


UUIDS = ("GPU-2b3c5d7e-0000-4000-8000-000000000006",
         "GPU-9f8e7d6c-0000-4000-8000-000000000004")


class TestNvidiaTimeshare:
    """A time-sliced claim on an NVIDIA card carries
    ``CUDA_VISIBLE_DEVICES=<GPU UUIDs>`` and no ``TPU_VISIBLE_CHIPS``:
    the port's gate locks per card UUID."""

    def env(self, tmp_path, cards=UUIDS[0], **extra):
        return {"TPU_TIMESHARE_DIR": str(tmp_path / "ts"),
                "TPU_RUNTIME_PREEMPTION_MS": "30",
                "CUDA_VISIBLE_DEVICES": cards, **extra}

    def test_from_env_takes_the_card_uuids(self, tmp_path):
        gate = TimeshareGate.from_env(self.env(tmp_path, ",".join(UUIDS)))
        assert gate.chips == [] and gate.cards == list(UUIDS)
        assert gate.lock_names == [f"{u}.lock" for u in UUIDS]
        # the reference's gate reads TPU_VISIBLE_CHIPS only: nothing
        jax_gate = JaxGate.from_env(self.env(tmp_path, ",".join(UUIDS)))
        assert jax_gate.chips == []
        gate.acquire()
        try:
            assert sorted(p.name for p in (tmp_path / "ts").iterdir()) == \
                sorted(f"{u}.lock" for u in UUIDS)
        finally:
            gate.release()

    def test_tpu_claim_and_neither_keep_the_reference(self, tmp_path):
        env = self.env(tmp_path, TPU_VISIBLE_CHIPS="1,3")
        gate = TimeshareGate.from_env(env)
        assert (gate.chips, gate.cards) == ([1, 3], [])
        assert gate.chips == JaxGate.from_env(env).chips
        env = self.env(tmp_path)
        del env["CUDA_VISIBLE_DEVICES"]
        gate = TimeshareGate.from_env(env)
        assert (gate.chips, gate.cards, gate.lock_names) == ([], [], [])

    @pytest.mark.parametrize("cards", ["0", "0,1", f"{UUIDS[0]},MIG-x"])
    def test_a_card_named_by_index_is_refused(self, tmp_path, cards):
        with pytest.raises(ValueError, match="not GPU UUIDs"):
            TimeshareGate.from_env(self.env(tmp_path, cards))

    def test_two_claims_on_one_card_exclude_each_other(self, tmp_path):
        assert_disjoint(held_quanta(
            lambda: TimeshareGate.from_env(self.env(tmp_path))))

    def test_two_gated_execs_never_run_at_once(self, tmp_path):
        """Two time-sliced claims' workloads under the gate binary, each
        with the card's UUID: between two ticks of one workload that are
        close together (it ran throughout) the other never ticks."""
        procs = []
        env = {**os.environ, **self.env(tmp_path)}
        env.pop("TPU_VISIBLE_CHIPS", None)
        env.pop("TPU_COORDINATOR_DIR", None)
        for name in "ab":
            procs.append(subprocess.Popen(
                [sys.executable, "-m", GATE, "exec", "--", sys.executable,
                 "-c", TICKER, str(tmp_path / f"{name}.ticks"), "1.2"],
                cwd=REPO, env=env))
        for p in procs:
            assert p.wait(timeout=60) == 0
        a, b = (read_ticks(tmp_path / f"{n}.ticks") for n in "ab")
        assert len(a) > 20 and len(b) > 20
        for mine, other in ((a, b), (b, a)):
            runs = [(s, e) for s, e in zip(mine, mine[1:]) if e - s < 10]
            inside = [t for t in other
                      if any(s < t < e for s, e in runs)]
            assert not inside, f"{len(inside)} ticks ran inside the " \
                               f"other claim's quanta"
        assert (tmp_path / "ts" / f"{UUIDS[0]}.lock").exists()


class TestHbmTranslation:
    """The budget as the CUDA caching allocator's option (the reference
    writes XLA's flags, which torch never reads); the fraction is the
    reference's, clamped the same way."""

    def client(self, tmp_path, limits, cls=CoordinatorClient):
        (tmp_path / "c").mkdir(exist_ok=True)
        (tmp_path / "c" / "schedule.json").write_text(
            json.dumps({"hbmLimits": limits}))
        return cls(tmp_path / "c", name="w")

    @pytest.mark.parametrize("limit,total", [
        (4 << 30, 85017493504), (1 << 20, 80 << 30), (90 << 30, 80 << 30),
        (40 << 30, 80 << 30)])
    def test_fraction_equals_the_references(self, tmp_path, limit, total):
        env, jax_env = {}, {}
        edits = self.client(tmp_path, {"GPU-a": limit}).apply_hbm_env(
            total, env)
        jax_edits = self.client(tmp_path, {"GPU-a": limit}, JaxClient
                                ).apply_hbm_env(total, jax_env)
        frac = jax_edits["XLA_PYTHON_CLIENT_MEM_FRACTION"]
        assert edits == {ENV_ALLOC_CONF: f"per_process_memory_fraction:{frac}"}
        assert env == edits
        assert abs(float(frac) - hbm_fraction(limit, total)) <= 5e-4

    def test_merged_into_the_options_already_set(self, tmp_path):
        env = {ENV_ALLOC_CONF: "expandable_segments:True,"
                               "per_process_memory_fraction:0.9, "
                               "max_split_size_mb:64"}
        edits = self.client(tmp_path, {"GPU-a": 8 << 30}).apply_hbm_env(
            80 << 30, env)
        assert edits[ENV_ALLOC_CONF] == (
            "expandable_segments:True,max_split_size_mb:64,"
            "per_process_memory_fraction:0.100")
        assert merge_alloc_conf("", 0.5) == "per_process_memory_fraction:0.500"

    def test_no_limit_no_edits(self, tmp_path):
        env = {}
        assert self.client(tmp_path, {}).apply_hbm_env(80 << 30, env) == {}
        assert env == {}

    def test_registered_limit_beats_the_claims(self, tmp_path):
        c = self.client(tmp_path, {"GPU-a": 8 << 30, "GPU-b": 8 << 30})
        assert c.hbm_limit_bytes() == 16 << 30
        c.register(hbm_limit_bytes=2 << 30)
        env = {}
        c.apply_hbm_env(80 << 30, env)
        assert env[ENV_ALLOC_CONF] == "per_process_memory_fraction:0.025"
