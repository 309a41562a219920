"""The port's per-claim coordinator daemon (the twin of
tests/test_coordinatord.py): the readiness file, schedule publication,
worker arbitration, the time-slicing policy files, the template the
port's plugin renders, the real process and its signals, and the
unregistered device-holder scan; then the NVIDIA host: ``auto`` device
paths are each visible minor's ``/dev/nvidia<i>`` (beside
``/dev/accel<i>``), never another card's node, and a holder of the
claim's card is reported while a holder of a decoy is not."""

import json
import logging
import os
import signal
import string
import subprocess
import sys
import time
from pathlib import Path

import yaml

from k8s_dra_driver_tpu.cmd import coordinatord as jax_coordinatord
from k8s_dra_driver_tpu_torch.cmd import coordinatord
from k8s_dra_driver_tpu_torch.cmd.coordinatord import Coordinator
from k8s_dra_driver_tpu_torch.plugin.sharing import (TEMPLATE_PATH,
                                                     TimeSlicingManager)

sys.path.insert(0, str(Path(__file__).parent))

from torch_plugin import COORDINATOR_COMMAND, host_args  # noqa: E402

REPO = Path(__file__).parent.parent
MODULE = "k8s_dra_driver_tpu_torch.cmd.coordinatord"


def make_coord(tmp_path, **kw):
    kw.setdefault("duty_cycle_percent", 80)
    kw.setdefault("preemption_ms", 0)
    kw.setdefault("hbm_limits", {"tpu-abc": 8 << 30})
    kw.setdefault("visible_chips", [0, 1])
    kw.setdefault("policy_dir", None)
    return Coordinator(tmp_path / "coord", **kw)


class TestCoordinator:
    def test_start_publishes_ready_and_schedule(self, tmp_path):
        c = make_coord(tmp_path)
        c.start()
        cdir = tmp_path / "coord"
        assert (cdir / "ready").exists()
        sched = json.loads((cdir / "schedule.json").read_text())
        assert sched["chips"] == [0, 1]
        assert sched["dutyCyclePercent"] == 80
        assert sched["hbmLimits"] == {"tpu-abc": 8 << 30}
        assert sched["slots"] == []
        c.stop()
        assert not (cdir / "ready").exists()
        assert (cdir / "schedule.json").exists()

    def test_worker_registration_splits_duty_cycle(self, tmp_path):
        c = make_coord(tmp_path)
        c.start()
        ctl = tmp_path / "coord" / "ctl"
        (ctl / "w1.json").write_text(json.dumps({"pid": 101}))
        assert c.step()
        sched = json.loads((tmp_path / "coord/schedule.json").read_text())
        assert [s["worker"] for s in sched["slots"]] == ["w1"]
        assert sched["slots"][0]["dutyCyclePercent"] == 80
        (ctl / "w2.json").write_text(json.dumps({"pid": 102}))
        assert c.step()
        sched = json.loads((tmp_path / "coord/schedule.json").read_text())
        assert [s["worker"] for s in sched["slots"]] == ["w1", "w2"]
        assert all(s["dutyCyclePercent"] == 40 for s in sched["slots"])
        (ctl / "w1.json").unlink()
        assert c.step()
        sched = json.loads((tmp_path / "coord/schedule.json").read_text())
        assert [s["worker"] for s in sched["slots"]] == ["w2"]

    def test_step_is_quiescent_without_changes(self, tmp_path):
        c = make_coord(tmp_path)
        c.start()
        seq = c.seq
        assert not c.step()
        assert c.seq == seq

    def test_malformed_registration_ignored(self, tmp_path):
        c = make_coord(tmp_path)
        c.start()
        (tmp_path / "coord/ctl/bad.json").write_text("{not json")
        c.step()
        sched = json.loads((tmp_path / "coord/schedule.json").read_text())
        assert sched["slots"] == []

    def test_non_object_registration_ignored(self, tmp_path):
        c = make_coord(tmp_path)
        c.start()
        (tmp_path / "coord/ctl/evil.json").write_text("42")
        (tmp_path / "coord/ctl/list.json").write_text("[1, 2]")
        (tmp_path / "coord/ctl/good.json").write_text(json.dumps({"pid": 7}))
        c.step()
        sched = json.loads((tmp_path / "coord/schedule.json").read_text())
        assert [s["worker"] for s in sched["slots"]] == ["good"]


class TestPolicyConsumption:
    def test_node_policy_overrides_claim_quantum(self, tmp_path):
        ts = TimeSlicingManager(str(tmp_path))          # writes policy/
        c = make_coord(tmp_path, preemption_ms=5,
                       policy_dir=tmp_path / "policy")
        c.start()
        assert c.effective_preemption_ms() == 5
        (tmp_path / "policy/chip1.json").write_text(
            json.dumps({"preemptionMs": 50}))
        assert c.effective_preemption_ms() == 50
        assert c.step()
        sched = json.loads((tmp_path / "coord/schedule.json").read_text())
        assert sched["preemptionMs"] == 50
        ts.reset([1])
        assert c.effective_preemption_ms() == 5

    def test_policy_for_other_chips_ignored(self, tmp_path):
        (tmp_path / "policy").mkdir()
        (tmp_path / "policy/chip7.json").write_text(
            json.dumps({"preemptionMs": 99}))
        c = make_coord(tmp_path, policy_dir=tmp_path / "policy")
        assert c.effective_preemption_ms() == 0

    def test_non_object_policy_degrades_to_claim_quantum(self, tmp_path):
        (tmp_path / "policy").mkdir()
        (tmp_path / "policy/chip0.json").write_text("[1, 2]")
        (tmp_path / "policy/chip1.json").write_text(
            json.dumps({"preemptionMs": 30}))
        (tmp_path / "policy/chip2.json").write_text(
            json.dumps({"preemptionMs": "999"}))
        c = make_coord(tmp_path, preemption_ms=5,
                       visible_chips=[0, 1, 2],
                       policy_dir=tmp_path / "policy")
        assert c.effective_preemption_ms() == 30


def render(tmp_path):
    text = string.Template(TEMPLATE_PATH.read_text()).substitute(
        name="tpu-coordinator-x", namespace="tpu-dra-driver",
        claim_uid="uid-1", id="x", node_name="node-1",
        image="registry.local/tpu-dra-driver:test",
        duty_cycle_percent="50",
        preemption_ms="0", hbm_limits="", visible_chips="0",
        coordination_dir=str(tmp_path / "c"),
        policy_dir=str(tmp_path / "p"),
        enforce="true", hbm_action="terminate")
    return yaml.safe_load(text)


class TestTemplateBuildCoherence:
    """The Deployment the port's plugin renders runs the port's daemon:
    its command is the reference's console script, which the port's
    beds and ``chip_smoke.py`` run as ``python -m`` of this module, and
    its args parse with this module's parser."""

    def test_command_is_a_declared_entrypoint(self, tmp_path):
        ctr = render(tmp_path)["spec"]["template"]["spec"]["containers"][0]
        cmd = ctr["command"][0]
        assert ctr["command"] == COORDINATOR_COMMAND
        scripts = (REPO / "pyproject.toml").read_text()
        assert f"{cmd} = " in scripts, \
            f"template command {cmd!r} not in [project.scripts]"
        dockerfile = (REPO / "deployments/container/Dockerfile").read_text()
        assert cmd in dockerfile
        res = subprocess.run([sys.executable, "-m", MODULE, "--help"],
                             cwd=REPO, capture_output=True, text=True,
                             timeout=60)
        assert res.returncode == 0 and "--coordination-dir" in res.stdout

    def test_args_parse_with_the_real_binary_parser(self, tmp_path):
        ctr = render(tmp_path)["spec"]["template"]["spec"]["containers"][0]
        ns = coordinatord.build_parser().parse_args(ctr["args"])
        assert ns.coordination_dir == "/coordination"
        assert ns.duty_cycle_percent == 50
        assert ns.policy_dir == "/policy"
        assert ns.hbm_action == "terminate"
        assert ns.device_paths == "auto"
        assert vars(ns) == vars(
            jax_coordinatord.build_parser().parse_args(ctr["args"]))

    def test_enforcement_posture_is_complete(self, tmp_path):
        pod = render(tmp_path)["spec"]["template"]["spec"]
        ctr = pod["containers"][0]
        assert pod["hostPID"] is True
        assert ctr["securityContext"]["privileged"] is True
        env = {e["name"]: e["value"] for e in ctr["env"]}
        assert env["ENFORCE"] == "true"
        assert ctr["terminationMessagePath"].startswith("/coordination")
        dev_mounts = [m for m in ctr["volumeMounts"]
                      if m["mountPath"] == "/dev"]
        assert dev_mounts and dev_mounts[0]["readOnly"] is True
        vols = {v["name"]: v for v in pod["volumes"]}
        assert vols["dev"]["hostPath"]["path"] == "/dev"
        # the host /dev mount maps the container's /dev onto itself, so
        # the auto paths name host nodes
        assert "--coordination-dir=" + str(tmp_path / "c") in \
            host_args(pod)

    def test_readiness_probe_matches_ready_file(self, tmp_path):
        ctr = render(tmp_path)["spec"]["template"]["spec"]["containers"][0]
        probe = ctr["readinessProbe"]["exec"]["command"]
        assert probe[-1] == "/coordination/" + coordinatord.READY_FILE


class TestRealProcess:
    def test_serve_ready_schedule_sigterm(self, tmp_path):
        cdir = tmp_path / "coord"
        cdir.mkdir()
        proc = subprocess.Popen(
            [sys.executable, "-m", MODULE,
             "--coordination-dir", str(cdir),
             "--duty-cycle-percent", "60",
             "--visible-chips", "0",
             "--policy-dir", "",
             "--poll-interval", "0.05"],
            cwd=REPO, stderr=subprocess.PIPE)
        try:
            deadline = time.time() + 10
            while not (cdir / "ready").exists():
                assert time.time() < deadline, "daemon never became ready"
                assert proc.poll() is None, proc.stderr.read().decode()
                time.sleep(0.02)
            (cdir / "ctl/w1.json").write_text("{}")
            while True:
                assert time.time() < deadline, "schedule never updated"
                sched = json.loads((cdir / "schedule.json").read_text())
                if sched["slots"]:
                    break
                time.sleep(0.02)
            assert sched["slots"][0]["worker"] == "w1"
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=10) == 0
            assert not (cdir / "ready").exists()
            assert "runpy" not in proc.stderr.read().decode()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def holder(device, extra=""):
    """A real process that opens the device node and sleeps."""
    return subprocess.Popen(
        [sys.executable, "-c",
         f"import os, time, sys\n{extra}\n"
         f"f = open({str(device)!r})\n"
         "print('open', flush=True)\n"
         "time.sleep(60)"],
        stdout=subprocess.PIPE, text=True)


def wait_open(proc):
    assert proc.stdout.readline().strip() == "open"


def intruders(c):
    return [v for v in c.violations
            if v.get("type") == "unregisteredDeviceHolder"]


def kill_group(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


class TestUnregisteredDeviceHolders:
    """Real processes holding real fds; /proc is the real /proc."""

    def test_intruder_detected_within_one_step(self, tmp_path):
        device = tmp_path / "dev-accel0"
        device.write_text("")
        c = make_coord(tmp_path, device_paths=[str(device)])
        c.start()
        intruder = holder(device)
        try:
            wait_open(intruder)
            c.step()
            [v] = intruders(c)
            assert v["pid"] == intruder.pid
            assert v["devices"] == [str(device)]
            assert v["action"] == "report"
            status = json.loads(
                (tmp_path / "coord/status.json").read_text())
            assert v in status["violations"]
        finally:
            intruder.kill()
            intruder.wait()

    def test_registered_worker_is_not_an_intruder(self, tmp_path):
        device = tmp_path / "dev-accel0"
        device.write_text("")
        c = make_coord(tmp_path, device_paths=[str(device)])
        c.start()
        h = holder(device)
        try:
            wait_open(h)
            (tmp_path / "coord/ctl/w1.json").write_text(json.dumps(
                {"pid": h.pid, "updatedAt": time.time()}))
            c.step()
            assert not intruders(c)
        finally:
            h.kill()
            h.wait()

    def test_gate_child_in_registered_group_is_not_an_intruder(
            self, tmp_path):
        device = tmp_path / "dev-accel0"
        device.write_text("")
        c = make_coord(tmp_path, device_paths=[str(device)])
        c.start()
        leader = subprocess.Popen(
            [sys.executable, "-c",
             "import os, time, sys\n"
             "os.setsid()\n"
             "pid = os.fork()\n"
             "if pid == 0:\n"
             f"    f = open({str(device)!r})\n"
             "    print('open', flush=True)\n"
             "    time.sleep(60)\n"
             "else:\n"
             "    time.sleep(60)\n"],
            stdout=subprocess.PIPE, text=True)
        try:
            assert leader.stdout.readline().strip() == "open"
            (tmp_path / "coord/ctl/gated.json").write_text(json.dumps(
                {"pid": leader.pid, "pidIsGroup": True,
                 "updatedAt": time.time()}))
            c.step()
            assert not intruders(c)
        finally:
            kill_group(leader)

    def test_enforce_terminate_kills_the_intruder(self, tmp_path):
        device = tmp_path / "dev-accel0"
        device.write_text("")
        c = make_coord(tmp_path, device_paths=[str(device)],
                       enforce=True, hbm_action="terminate")
        c.start()
        intruder = holder(device)
        try:
            wait_open(intruder)
            c.step()
            [v] = intruders(c)
            assert v["action"] == "terminate"
            assert intruder.wait(timeout=10) == -signal.SIGTERM
        finally:
            if intruder.poll() is None:
                intruder.kill()
                intruder.wait()

    def test_forked_child_of_registered_worker_is_not_an_intruder(
            self, tmp_path):
        device = tmp_path / "dev-accel0"
        device.write_text("")
        c = make_coord(tmp_path, device_paths=[str(device)])
        c.start()
        parent = subprocess.Popen(
            [sys.executable, "-c",
             "import os, time\n"
             f"f = open({str(device)!r})\n"
             "pid = os.fork()\n"
             "if pid == 0:\n"
             "    print('forked', flush=True)\n"
             "    time.sleep(60)\n"
             "else:\n"
             "    time.sleep(60)\n"],
            stdout=subprocess.PIPE, text=True,
            start_new_session=True)
        try:
            assert parent.stdout.readline().strip() == "forked"
            (tmp_path / "coord/ctl/plain.json").write_text(json.dumps(
                {"pid": parent.pid, "updatedAt": time.time()}))
            c.step()
            assert not intruders(c)
        finally:
            kill_group(parent)

    def test_stale_evicted_worker_gets_grace_before_intrusion(
            self, tmp_path):
        device = tmp_path / "dev-accel0"
        device.write_text("")
        c = make_coord(tmp_path, device_paths=[str(device)],
                       stale_after_s=5.0)
        c.start()
        h = holder(device)
        try:
            wait_open(h)
            (tmp_path / "coord/ctl/w1.json").write_text(json.dumps(
                {"pid": h.pid, "heartbeatAtMs": c.now_ms() - 6000}))
            c.step()
            assert not intruders(c)
            assert h.pid in c._evicted_at
        finally:
            h.kill()
            h.wait()


class TestNvidiaDevicePaths:
    """``--device-paths auto`` on an NVIDIA host: the visible minors'
    ``/dev/nvidia<i>`` beside ``/dev/accel<i>``, and the holder scan
    over a fake tree and a fake ``/proc`` whose fd links name its
    nodes."""

    def tree(self, tmp_path):
        dev = tmp_path / "dev"
        dev.mkdir()
        for name in ("nvidia6", "nvidia0", "nvidiactl", "nvidia-uvm"):
            (dev / name).write_text("")
        return dev

    def fake_proc(self, tmp_path, holders):
        """``proc/<pid>/fd/3`` linked to each holder's node, for real
        pids (the scan asks the kernel for each holder's group)."""
        proc = tmp_path / "proc"
        for pid, node in holders.items():
            (proc / str(pid) / "fd").mkdir(parents=True)
            os.symlink(node, proc / str(pid) / "fd" / "3")
            (proc / str(pid) / "comm").write_text("python3\n")
            (proc / str(pid) / "stat").write_text(
                f"{pid} (python3) S 1 1 1 0 -1 0 0 0 0 0 0 0 0 0 20 0 1 0 "
                f"{1000 + pid} 0 0\n")
        return proc

    def test_auto_paths_are_the_visible_minors(self, tmp_path):
        assert coordinatord.resolve_device_paths("auto", [6]) == \
            ["/dev/accel6", "/dev/nvidia6"]
        assert coordinatord.resolve_device_paths("auto", [0, 2]) == \
            ["/dev/accel0", "/dev/nvidia0", "/dev/accel2", "/dev/nvidia2"]
        assert coordinatord.resolve_device_paths("", [6]) == []
        assert coordinatord.resolve_device_paths("/dev/x,/dev/y", [6]) == \
            ["/dev/x", "/dev/y"]
        dev = self.tree(tmp_path)
        paths = coordinatord.auto_device_paths([6], str(dev))
        assert [p for p in paths if os.path.exists(p)] == \
            [str(dev / "nvidia6")]
        # a TPU host's auto paths keep the reference's accel node
        ns = coordinatord.build_parser().parse_args(
            ["--visible-chips", "1,3"])
        assert [p for p in coordinatord.resolve_device_paths(
            ns.device_paths, coordinatord._parse_chips(ns.visible_chips))
            if "accel" in p] == ["/dev/accel1", "/dev/accel3"]

    def test_card_holder_reported_decoy_holder_not(self, tmp_path):
        dev = self.tree(tmp_path)
        procs = [subprocess.Popen([sys.executable, "-c",
                                   "import time; time.sleep(60)"])
                 for _ in range(3)]
        card, decoy, ctl = procs
        try:
            proc_root = self.fake_proc(tmp_path, {
                card.pid: dev / "nvidia6", decoy.pid: dev / "nvidia0",
                ctl.pid: dev / "nvidiactl"})
            c = make_coord(tmp_path, visible_chips=[6],
                           device_paths=coordinatord.auto_device_paths(
                               [6], str(dev)),
                           proc_root=str(proc_root))
            c.start()
            [v] = intruders(c)
            assert v == {"type": "unregisteredDeviceHolder",
                         "pid": card.pid, "comm": "python3",
                         "devices": [str(dev / "nvidia6")],
                         "action": "report"}
            status = json.loads((tmp_path / "coord/status.json").read_text())
            assert status["violations"] == [v]
            # registered, the card's holder is a worker
            (tmp_path / "coord/ctl/w0.json").write_text(
                json.dumps({"pid": card.pid}))
            c.step()
            assert not intruders(c)
        finally:
            for p in procs:
                p.kill()
                p.wait()

    def test_main_watches_the_visible_minor(self, tmp_path, monkeypatch):
        """``main`` hands the Coordinator the auto paths of its
        ``--visible-chips``."""
        seen = {}

        class Probe(Coordinator):
            def serve(self, poll_interval, stop_event):
                seen["paths"] = self.device_paths

        monkeypatch.setattr(coordinatord, "Coordinator", Probe)
        # main installs signal handlers and the root log handler: keep
        # this process's own
        monkeypatch.setattr(coordinatord.signal, "signal",
                            lambda *a: None)
        root = logging.getLogger()
        saved = root.handlers[:], root.level
        try:
            assert coordinatord.main(
                ["--coordination-dir", str(tmp_path / "c"),
                 "--visible-chips", "6", "--policy-dir", ""]) == 0
        finally:
            root.handlers[:], _ = saved
            root.setLevel(saved[1])
        assert seen["paths"] == ["/dev/accel6", "/dev/nvidia6"]
