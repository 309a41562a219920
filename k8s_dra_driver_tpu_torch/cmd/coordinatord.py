"""The per-claim runtime coordinator daemon (the port of
``k8s_dra_driver_tpu/cmd/coordinatord.py``, the reference's
``tpu-coordinatord``), run as ``python -m
k8s_dra_driver_tpu_torch.cmd.coordinatord``.  It imports no torch.

The TPU-native analog of ``nvidia-cuda-mps-control`` (the reference
launches it inside a templated Deployment,
reference templates/mps-control-daemon.tmpl.yaml:26-42, lifecycle
cmd/nvidia-dra-plugin/sharing.go:185-366). Where MPS arbitrates SM
access through a control pipe, the TPU coordinator arbitrates chip
access through the claim's *coordination directory* (bind-mounted into
every workload container by the per-claim CDI spec):

- **readiness** — writes ``<dir>/ready`` once serving; the Deployment's
  readiness probe checks that file, so the plugin's ``assert_ready``
  poll (plugin/sharing.py) observes real daemon liveness instead of
  bare pod scheduling.
- **policy consumption** — merges the claim-level settings (flags) with
  the node-level per-chip time-slicing policy files written by
  ``TimeSlicingManager`` (plugin/sharing.py:_write_policy) under the
  plugin policy dir; this is the consumer those files previously
  lacked.
- **worker arbitration** — workloads register by dropping
  ``ctl/<worker>.json``; the daemon assigns round-robin duty-cycle
  slots and publishes ``schedule.json`` (the moral equivalent of MPS
  ``set_active_thread_percentage`` flowing through the control pipe,
  sharing.go:260-271).
- **heartbeat/status** — ``status.json`` carries pid, seq and the
  effective policy for debugging and tests.

All files are written atomically (tmp + rename) so workload readers
never observe torn JSON.

The device-holder scan watches the claim's device nodes: with
``--device-paths auto``, for each visible index, ``/dev/accel<i>`` (a TPU
chip) and ``/dev/nvidia<i>`` (an NVIDIA card, whose index is its minor);
the scan drops paths that do not exist, so a TPU host watches what the
reference watches.  Never ``/dev/nvidiactl`` or ``/dev/nvidia-uvm``:
every CUDA process holds those.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import time
from pathlib import Path

from ..coordclient import schedule as sched
from ..utils import info
from ..utils.files import atomic_write
from ..utils.flags import LoggingConfig, env_default

log = logging.getLogger("tpu-coordinatord")

READY_FILE = "ready"
SCHEDULE_FILE = "schedule.json"
STATUS_FILE = "status.json"

HBM_ACTION_REPORT = "report"
HBM_ACTION_TERMINATE = "terminate"

#: registrations whose newest timestamp is older than this are evicted
#: (a SIGKILLed workload never runs its gate's unregister; without
#: eviction its slot wastes chip time forever and — worse — its pid
#: gets signaled after kernel pid reuse).  Clients heartbeat at
#: coordclient.client.HEARTBEAT_INTERVAL_S, well inside this.
DEFAULT_STALE_AFTER_S = 15.0


def _read_json_dict(path: Path) -> dict | None:
    """Read a JSON object from an untrusted drop-file; None on any
    failure (torn write, non-JSON, valid-but-non-object payload)."""
    try:
        payload = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    return payload if isinstance(payload, dict) else None


def _parse_hbm_limits(spec: str) -> dict[str, int]:
    """``uuid=bytes,uuid=bytes`` (as rendered by CoordinatorDaemon.start)."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad --hbm-limits entry {part!r}")
        uuid, _, byts = part.partition("=")
        out[uuid] = int(byts)
    return out


def _parse_chips(spec: str) -> list[int]:
    return [int(x) for x in spec.split(",") if x.strip() != ""]


def auto_device_paths(chips: list[int], dev_root: str = "/dev") -> list[str]:
    """``--device-paths auto``: each visible index's TPU node and NVIDIA
    card node; the visible minors only, never every ``nvidia*`` (a host
    may show a ``/dev/nvidia0`` that is not the claim's card)."""
    return [f"{dev_root}/{kind}{i}" for i in chips
            for kind in ("accel", "nvidia")]


def resolve_device_paths(spec: str, chips: list[int],
                         dev_root: str = "/dev") -> list[str]:
    """The ``--device-paths`` value as a list: ``auto`` (see
    :func:`auto_device_paths`), or a csv of nodes ('' disables the
    scan)."""
    if spec == "auto":
        return auto_device_paths(chips, dev_root)
    return [s for s in spec.split(",") if s]


class Coordinator:
    """One claim's coordinator state machine.

    Separated from the CLI loop so tests can drive ``step()``
    synchronously; the binary calls ``serve()`` which loops it.
    """

    def __init__(self, coordination_dir: Path, *, duty_cycle_percent: int,
                 preemption_ms: int, hbm_limits: dict[str, int],
                 visible_chips: list[int], policy_dir: Path | None,
                 enforce: bool = False,
                 hbm_action: str = HBM_ACTION_REPORT,
                 stale_after_s: float = DEFAULT_STALE_AFTER_S,
                 device_paths: list[str] | None = None,
                 proc_root: str = "/proc",
                 holder_scan_every: int = 1,
                 now_ms=lambda: time.time() * 1000.0):
        self.dir = Path(coordination_dir)
        self.duty_cycle_percent = duty_cycle_percent
        self.claim_preemption_ms = preemption_ms
        self.hbm_limits = hbm_limits
        self.visible_chips = visible_chips
        self.policy_dir = Path(policy_dir) if policy_dir else None
        self.enforce = enforce
        self.hbm_action = hbm_action
        self.stale_after_s = stale_after_s
        self.now_ms = now_ms
        self.seq = 0
        self._last_schedule: str | None = None
        # Timebase every participant's window math is phased against;
        # fixed at construction so republishing never shifts windows.
        self.epoch_ms = now_ms()
        self._stopped_pids: set[int] = set()
        # worker name -> pid we SIGTERMed; a re-registration with a NEW
        # pid is a fresh process and gets fresh enforcement.
        self._terminated: dict[str, int] = {}
        # Device nodes whose holders must be registered workers.
        # OPT-IN at the library level (None disables the scan) so
        # in-process Coordinator uses stay hermetic — a default-on
        # /proc scan would let a unit test on a real TPU host observe
        # (or under terminate, kill) unrelated holders of the real
        # /dev/accel*.  The BINARY defaults it on (main() derives
        # /dev/accel<i> and /dev/nvidia<i> from the visible chips).
        # proc_root is overridable for tests.
        self.device_paths = device_paths or []
        self.proc_root = proc_root
        # intruder pid -> /proc starttime when we SIGTERMed it; the
        # starttime disambiguates kernel pid reuse (a recycled pid is
        # a fresh process and gets fresh enforcement, like the HBM
        # path's name->pid map at _terminated)
        self._intruders_terminated: dict[int, int] = {}
        # Readlinking every fd on a hostPID node is not free: scan on
        # every Nth step only (the binary defaults N=5 at 1s polls; the
        # violation SLO is one *scan* tick).  Sticky between scans so
        # status.json keeps showing a live violation.
        self.holder_scan_every = max(1, holder_scan_every)
        self._steps = 0
        self._holder_violations: list[dict] = []
        # pid -> monotonic eviction time: a stale-evicted worker gets a
        # grace window before its still-open device fd counts as an
        # intrusion, so eviction stays recoverable (re-register) rather
        # than escalating straight to SIGTERM
        self._evicted_at: dict[int, float] = {}
        self.violations: list[dict] = []
        # step()-refreshed caches so enforce_tick (which runs at
        # sub-quantum frequency) does no disk IO of its own.
        self._schedule_cache: dict = {}
        self._workers_cache: list[dict] = []
        self._quantum_cache: int = 0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        (self.dir / "ctl").mkdir(parents=True, exist_ok=True)
        (self.dir / "log").mkdir(parents=True, exist_ok=True)
        self.step()                      # publish an initial schedule
        atomic_write(self.dir / READY_FILE,
                      json.dumps({"pid": os.getpid(),
                                  "startedSeq": self.seq}))
        log.info("coordinator ready: dir=%s chips=%s duty=%d%%",
                 self.dir, self.visible_chips, self.duty_cycle_percent)

    def stop(self) -> None:
        (self.dir / READY_FILE).unlink(missing_ok=True)
        log.info("coordinator stopped")

    # -- one arbitration round ----------------------------------------

    def effective_preemption_ms(self) -> int:
        """Claim-level quantum, overridden by node-level per-chip policy
        (the TimeSlicingManager files — their consumer)."""
        quantum = self.claim_preemption_ms
        if self.policy_dir is not None:
            for chip in self.visible_chips:
                policy = _read_json_dict(self.policy_dir / f"chip{chip}.json")
                if policy is None:
                    continue             # malformed node policy: degrade
                node_ms = policy.get("preemptionMs", 0)
                if not isinstance(node_ms, (int, float)) \
                        or isinstance(node_ms, bool):
                    continue             # non-numeric quantum: degrade
                quantum = max(quantum, int(node_ms))
        return quantum

    def workers(self) -> list[dict]:
        """Registered workloads: ``ctl/<name>.json`` drop-files.
        Evicts registrations that stopped heartbeating ``stale_after_s``
        ago — a SIGKILLed gate never unregisters, and keeping its slot
        both wastes chip time and risks signaling a recycled pid."""
        found = []
        ctl = self.dir / "ctl"
        if not ctl.is_dir():
            return found
        now = self.now_ms()
        for path in sorted(ctl.glob("*.json")):
            reg = _read_json_dict(path)
            if reg is None:
                continue             # torn write or non-object payload
            reg["name"] = path.stem
            last = reg.get("heartbeatAtMs", reg.get("registeredAtMs"))
            if self.stale_after_s > 0 and isinstance(last, (int, float)) \
                    and not isinstance(last, bool) \
                    and now - last > self.stale_after_s * 1000:
                log.warning("evicting stale worker %s (last seen %.1fs ago)",
                            reg["name"], (now - last) / 1000)
                self._forget_worker(reg)
                path.unlink(missing_ok=True)
                continue
            found.append(reg)
        return found

    def _forget_worker(self, reg: dict) -> None:
        """Never leave an evicted worker's pid frozen, and let a future
        re-registration get fresh HBM enforcement."""
        pid = reg.get("pid")
        if isinstance(pid, int):
            if pid in self._stopped_pids:
                try:
                    self._signal_worker(reg, signal.SIGCONT)
                except (ProcessLookupError, PermissionError):
                    pass
                self._stopped_pids.discard(pid)
            self._evicted_at[pid] = time.monotonic()
        self._terminated.pop(reg["name"], None)

    def step(self) -> bool:
        """Recompute + publish the schedule; True if it changed."""
        quantum = self.effective_preemption_ms()
        workers = self.workers()
        self._workers_cache = workers
        self._quantum_cache = quantum
        cycle = sched.cycle_ms_for(quantum)
        windows = sched.compute_windows(workers, self.duty_cycle_percent,
                                        cycle)
        slots = [{
            "worker": win.worker,
            "slot": i,
            "offsetMs": round(win.offset_ms, 3),
            "windowMs": round(win.window_ms, 3),
            "dutyCyclePercent": (self.duty_cycle_percent // len(workers)
                                 if workers else self.duty_cycle_percent),
        } for i, win in enumerate(windows)]
        schedule = {
            "chips": self.visible_chips,
            "preemptionMs": quantum,
            "dutyCyclePercent": self.duty_cycle_percent,
            "hbmLimits": self.hbm_limits,
            "epochMs": self.epoch_ms,
            "cycleMs": cycle,
            "slots": slots,
        }
        text = json.dumps(schedule, sort_keys=True)
        self._schedule_cache = schedule
        changed = text != self._last_schedule
        if changed:
            self.seq += 1
            self._last_schedule = text
            atomic_write(self.dir / SCHEDULE_FILE, text)
        # prune here, not in the holder scan: with the scan disabled
        # (or no device nodes present) the grace dict would otherwise
        # grow by one entry per eviction for the daemon's lifetime
        now_mono = time.monotonic()
        grace_s = max(self.stale_after_s, 1.0)
        self._evicted_at = {p: t for p, t in self._evicted_at.items()
                            if now_mono - t < grace_s}
        if self._steps % self.holder_scan_every == 0:
            self._holder_violations = self._check_device_holders(workers)
        self._steps += 1
        self.violations = self._check_hbm(workers) + \
            self._holder_violations
        atomic_write(self.dir / STATUS_FILE, json.dumps({
            "pid": os.getpid(),
            "seq": self.seq,
            "workers": len(workers),
            "preemptionMs": quantum,
            "enforce": self.enforce,
            "violations": self.violations,
            "updatedAt": time.time(),
        }))
        return changed

    # -- HBM limit supervision ----------------------------------------

    def _worker_limit(self, reg: dict) -> int | None:
        limit = reg.get("hbmLimitBytes")
        if isinstance(limit, (int, float)) and not isinstance(limit, bool):
            return int(limit)
        if self.hbm_limits:
            return sum(self.hbm_limits.values())
        return None

    def _check_hbm(self, workers: list[dict]) -> list[dict]:
        """Compare heartbeat-reported HBM usage against limits (the
        detection half of a limit); ``terminate`` additionally SIGTERMs
        the violator (once) when enforcing."""
        out = []
        for reg in workers:
            used = reg.get("hbmBytesInUse")
            if not isinstance(used, (int, float)) or isinstance(used, bool):
                continue
            limit = self._worker_limit(reg)
            if limit is None or used <= limit:
                continue
            record = {"worker": reg["name"], "usedBytes": int(used),
                      "limitBytes": limit, "action": self.hbm_action}
            out.append(record)
            log.warning("HBM violation: worker %s uses %d > limit %d",
                        reg["name"], used, limit)
            pid = reg.get("pid")
            # Terminate once per PROCESS: a worker that re-registers
            # under the same name with a new pid (container restart) is
            # a fresh violator and gets enforced again.
            if (self.hbm_action == HBM_ACTION_TERMINATE and self.enforce
                    and isinstance(pid, int) and pid > 1
                    and self._terminated.get(reg["name"]) != pid):
                try:
                    self._signal_worker(reg, signal.SIGTERM)
                    self._terminated[reg["name"]] = pid
                    log.warning("terminated worker %s (pid %d)",
                                reg["name"], pid)
                except (ProcessLookupError, PermissionError) as e:
                    log.warning("cannot terminate pid %d: %s", pid, e)
        return out

    # -- unregistered device-holder supervision ------------------------

    def _check_device_holders(self, workers: list[dict]) -> list[dict]:
        """Detect processes holding the claim's device nodes without a
        registration — the enforcement escape the gate alone leaves
        open (a pod that skips the gate's ``exec`` touches the chip
        invisibly).  The reference cannot be bypassed at this level
        because compute mode is set in the driver itself (reference
        cmd/nvidia-dra-plugin/nvlib.go:541-558); our floor is
        node-level detection: scan ``/proc/*/fd`` for the claim's
        ``/dev/accel*`` or ``/dev/nvidia<i>`` nodes and flag any holder
        that is neither a registered worker pid nor inside a registered
        gate's process group.  ``terminate`` + ``--enforce`` SIGTERMs the
        intruder (once per pid); otherwise it is reported in
        status.json.  Needs the workload PID namespace (hostPID
        DaemonSet or in-pod sidecar), like enforce_tick."""
        # a node without the device nodes has nothing to hold (and the
        # scan is skipped entirely, keeping chip-less hosts cheap); an
        # NVIDIA host has no /dev/accel*, a TPU host no /dev/nvidia<i>
        targets = {str(Path(p).resolve()) for p in self.device_paths
                   if os.path.exists(p)}
        if not targets:
            return []
        # Exempt registered pids AND their process groups: forked
        # children inherit the device fd (dataloaders, runtime helper
        # procs) and share the parent's pgid, whether or not the
        # registration is a gate group leader.
        pids: set[int] = set(self._evicted_at)
        pgids: set[int] = set()
        for reg in workers:
            pid = reg.get("pid")
            if isinstance(pid, int) and pid > 1:
                pids.add(pid)
                if reg.get("pidIsGroup") is True:
                    pgids.add(pid)
                else:
                    try:
                        pgids.add(os.getpgid(pid))
                    except (OSError, ProcessLookupError):
                        pass
        out = []
        try:
            entries = os.listdir(self.proc_root)
        except OSError:
            return []
        for entry in entries:
            if not entry.isdigit():
                continue
            pid = int(entry)
            if pid == os.getpid() or pid in pids:
                continue
            fd_dir = os.path.join(self.proc_root, entry, "fd")
            try:
                fds = os.listdir(fd_dir)
            except OSError:
                continue          # exited, or not ours to inspect
            held: set[str] = set()
            for fd in fds:
                try:
                    tgt = os.readlink(os.path.join(fd_dir, fd))
                except OSError:
                    continue
                if tgt in targets:
                    held.add(tgt)
                    if len(held) == len(targets):
                        break     # nothing more to learn from this pid
            if not held:
                continue
            try:
                if os.getpgid(pid) in pgids:
                    continue      # a registered workload's child
            except (OSError, ProcessLookupError):
                continue          # raced with exit
            try:
                comm = Path(self.proc_root, entry, "comm").read_text(
                ).strip()
            except OSError:
                comm = ""
            record = {"type": "unregisteredDeviceHolder", "pid": pid,
                      "comm": comm, "devices": sorted(held),
                      "action": self.hbm_action}
            out.append(record)
            log.warning("unregistered process %d (%s) holds %s",
                        pid, comm, ",".join(sorted(held)))
            if self.hbm_action == HBM_ACTION_TERMINATE and self.enforce:
                start = self._proc_starttime(pid)
                # terminate once per PROCESS: starttime distinguishes a
                # recycled pid (fresh process) from one already signaled
                if self._intruders_terminated.get(pid) != start:
                    try:
                        os.kill(pid, signal.SIGTERM)
                        self._intruders_terminated[pid] = start
                        log.warning("terminated intruder pid %d", pid)
                    except (ProcessLookupError, PermissionError) as e:
                        log.warning("cannot terminate pid %d: %s",
                                    pid, e)
        # prune terminate-dedup entries for processes that are gone (or
        # whose pid was recycled — the starttime check above handles
        # the race where the recycled pid is also an intruder)
        self._intruders_terminated = {
            p: s for p, s in self._intruders_terminated.items()
            if self._proc_starttime(p) == s}
        return out

    def _proc_starttime(self, pid: int) -> int | None:
        """Kernel start time (clock ticks) from /proc/<pid>/stat field
        22 — the stable identity of a pid across kernel pid reuse.
        None when the process is gone."""
        try:
            stat = Path(self.proc_root, str(pid), "stat").read_text()
            # comm (field 2) may contain spaces/parens; fields after it
            # start beyond the LAST ')'
            return int(stat.rpartition(")")[2].split()[19])
        except (OSError, ValueError, IndexError):
            return None

    # -- duty-cycle enforcement ---------------------------------------

    def enforce_tick(self) -> None:
        """Signal registered worker pids to match the schedule: SIGCONT
        whoever's window is open, SIGSTOP everyone else.  Only
        meaningful when the daemon shares a PID namespace with the
        workloads (hostPID DaemonSet or in-pod sidecar); cross-pod
        deployments get the same behavior from each workload's own
        gate (``coordclient/gate.py`` ``exec``)."""
        if not self._schedule_cache:
            return
        active = sched.active_worker(self._schedule_cache, self.now_ms())
        # Cached worker list: this runs at sub-quantum frequency and
        # must not re-read ctl/ every tick; registration changes land
        # at the next step() (≤ one poll interval away).
        for reg in self._workers_cache:
            pid = reg.get("pid")
            if not isinstance(pid, int) or pid <= 1 or pid == os.getpid():
                continue
            run = reg["name"] == active
            try:
                if run and pid in self._stopped_pids:
                    self._signal_worker(reg, signal.SIGCONT)
                    self._stopped_pids.discard(pid)
                elif not run and pid not in self._stopped_pids:
                    self._signal_worker(reg, signal.SIGSTOP)
                    self._stopped_pids.add(pid)
            except (ProcessLookupError, PermissionError):
                self._stopped_pids.discard(pid)

    @staticmethod
    def _signal_worker(reg: dict, sig: int) -> None:
        """Signal the worker's whole process group when its
        registration vouches the pid is a group leader (the gate's
        children are session leaders) — otherwise a forked workload
        would escape daemon-side enforcement; fall back to the pid."""
        pid = reg["pid"]
        if reg.get("pidIsGroup") is True:
            try:
                os.killpg(pid, sig)
                return
            except (ProcessLookupError, PermissionError):
                pass
        os.kill(pid, sig)

    def release_all(self) -> None:
        """SIGCONT everything we froze (shutdown path — never leave
        workloads stopped behind a dead coordinator).  Uses the cached
        registrations so group-frozen workers (pidIsGroup) get their
        whole group resumed, not just the leader."""
        regs = {reg.get("pid"): reg for reg in self._workers_cache
                if isinstance(reg.get("pid"), int)}
        for pid in list(self._stopped_pids):
            try:
                self._signal_worker(regs.get(pid, {"pid": pid}),
                                    signal.SIGCONT)
            except (ProcessLookupError, PermissionError):
                pass
        self._stopped_pids.clear()

    def serve(self, poll_interval: float, stop_event) -> None:
        """Arbitration loop.  Schedule recomputation runs every
        ``poll_interval``; when ``enforce`` is on, the signal-based
        duty-cycle enforcer ticks much faster (a fraction of the
        preemption quantum) so window boundaries are honored with
        sub-quantum latency."""
        self.start()
        try:
            next_step = time.monotonic()
            while not stop_event.is_set():
                now = time.monotonic()
                if now >= next_step:
                    self.step()
                    next_step = now + poll_interval
                if self.enforce:
                    self.enforce_tick()
                    quantum = self._quantum_cache or sched.DEFAULT_CYCLE_MS
                    tick = min(poll_interval, max(0.002, quantum / 1000 / 8))
                    stop_event.wait(tick)
                else:
                    stop_event.wait(max(0.0, next_step - time.monotonic()))
        finally:
            self.release_all()
            self.stop()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m k8s_dra_driver_tpu_torch.cmd.coordinatord",
        description="Per-claim runtime coordinator for TPU and NVIDIA "
                    "claims (MPS control-daemon analog)")
    p.add_argument("--version", action="version",
                   version=info.get_version_string())
    p.add_argument("--coordination-dir",
                   default=env_default("COORDINATION_DIR", "/coordination"),
                   help="claim coordination directory (bind-mounted into "
                        "workloads) [env COORDINATION_DIR]")
    p.add_argument("--duty-cycle-percent", type=int,
                   default=env_default("DUTY_CYCLE_PERCENT", 100, int),
                   help="claim compute share [env DUTY_CYCLE_PERCENT]")
    p.add_argument("--preemption-ms", type=int,
                   default=env_default("PREEMPTION_MS", 0, int),
                   help="claim-level preemption quantum; node policy "
                        "files may raise it [env PREEMPTION_MS]")
    p.add_argument("--hbm-limits",
                   default=env_default("HBM_LIMITS", ""),
                   help="per-device HBM caps, uuid=bytes csv "
                        "[env HBM_LIMITS]")
    p.add_argument("--visible-chips",
                   default=env_default("VISIBLE_CHIPS", ""),
                   help="chip indices this claim spans [env VISIBLE_CHIPS]")
    p.add_argument("--policy-dir",
                   default=env_default("POLICY_DIR", "/policy"),
                   help="node time-slicing policy dir (written by the "
                        "plugin's TimeSlicingManager) [env POLICY_DIR]")
    p.add_argument("--poll-interval", type=float,
                   default=env_default("POLL_INTERVAL", 1.0, float),
                   help="arbitration loop period seconds "
                        "[env POLL_INTERVAL] (default 1)")
    p.add_argument("--stale-after", type=float,
                   default=env_default("STALE_AFTER", DEFAULT_STALE_AFTER_S,
                                       float),
                   help="evict registrations silent this many seconds "
                        "(0 disables) [env STALE_AFTER]")
    p.add_argument("--enforce", action="store_true",
                   default=env_default("ENFORCE", "", str) == "true",
                   help="SIGSTOP/SIGCONT registered worker pids to the "
                        "schedule (requires a shared PID namespace: "
                        "in-pod sidecar or hostPID) [env ENFORCE=true]")
    p.add_argument("--device-paths",
                   default=env_default("DEVICE_PATHS", "auto"),
                   help="csv of device nodes whose holders must be "
                        "registered workers; 'auto' = /dev/accel<i> and "
                        "/dev/nvidia<i> for each visible index, '' "
                        "disables the scan. "
                        "Unregistered holders are reported as "
                        "violations, or SIGTERMed under --enforce "
                        "with terminate action [env DEVICE_PATHS]")
    p.add_argument("--holder-scan-every", type=int,
                   default=env_default("HOLDER_SCAN_EVERY", 5, int),
                   help="run the /proc device-holder scan on every "
                        "Nth poll (it readlinks every fd on the node) "
                        "[env HOLDER_SCAN_EVERY] (default 5)")
    p.add_argument("--hbm-action",
                   choices=[HBM_ACTION_REPORT, HBM_ACTION_TERMINATE],
                   default=env_default("HBM_ACTION", HBM_ACTION_REPORT),
                   help="on HBM-limit violation: report in status.json, "
                        "or additionally SIGTERM the violator when "
                        "--enforce [env HBM_ACTION]")
    LoggingConfig.add_flags(p)
    return p


def main(argv: list[str] | None = None) -> int:
    import threading

    args = build_parser().parse_args(argv)
    LoggingConfig.apply(args)

    policy_dir = Path(args.policy_dir) if args.policy_dir else None
    if policy_dir is not None and not policy_dir.is_dir():
        log.warning("policy dir %s absent; claim-level settings only",
                    policy_dir)
        policy_dir = None
    coord = Coordinator(
        Path(args.coordination_dir),
        duty_cycle_percent=args.duty_cycle_percent,
        preemption_ms=args.preemption_ms,
        hbm_limits=_parse_hbm_limits(args.hbm_limits),
        visible_chips=_parse_chips(args.visible_chips),
        policy_dir=policy_dir,
        enforce=args.enforce,
        hbm_action=args.hbm_action,
        stale_after_s=args.stale_after,
        device_paths=resolve_device_paths(
            args.device_paths, _parse_chips(args.visible_chips)),
        holder_scan_every=args.holder_scan_every)

    stop = threading.Event()

    def on_signal(signum, frame):
        log.info("signal %d: shutting down", signum)
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    coord.serve(args.poll_interval, stop)
    return 0


if __name__ == "__main__":
    sys.exit(main())
