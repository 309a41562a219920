"""The workload-side enforcement gate (the port of
``k8s_dra_driver_tpu/coordclient/gate.py``, the reference's
``tpu-coordclient``).

Runs the real workload as a child process and holds it to the
coordinator's published duty-cycle schedule with SIGSTOP/SIGCONT: the
child computes only while its window is open.  Because every pod gates
*its own child*, enforcement needs no shared PID namespace and no
privileges; the pod's entrypoint simply becomes::

    python -m k8s_dra_driver_tpu_torch.coordclient.gate exec --name w0 \
        -- python train.py

Also exposed: ``wait`` (block until the window opens, for shell
pipelines that want cooperative gating without the wrapper) and
``status`` (print the schedule and whose turn it is).

For *plain time-sliced* claims (no coordinator daemon), ``exec`` falls
back to `TimeshareGate`: a flock per device under the node's timeshare
directory that claims acquire for one preemption quantum at a time, so
``TPU_RUNTIME_PREEMPTION_MS`` gates real device access.  A TPU claim
names its chips in ``TPU_VISIBLE_CHIPS`` and locks ``chip<i>.lock``; a
claim on an NVIDIA card carries ``CUDA_VISIBLE_DEVICES=<GPU UUIDs>`` and
no ``TPU_VISIBLE_CHIPS``, and locks ``<uuid>.lock`` per card, so every
claim on one card (a core claim names its whole card) contends for the
same lock.  A SIGSTOPped child launches nothing, but work it queued on
the card before the stop still runs out.
"""

from __future__ import annotations

import argparse
import fcntl
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from . import schedule as sched
from .client import ENV_COORDINATION_DIR, CoordinatorClient

ENV_TIMESHARE_DIR = "TPU_TIMESHARE_DIR"
ENV_PREEMPTION_MS = "TPU_RUNTIME_PREEMPTION_MS"
ENV_VISIBLE_CHIPS = "TPU_VISIBLE_CHIPS"
ENV_CUDA_VISIBLE = "CUDA_VISIBLE_DEVICES"
#: the prefix of an NVIDIA card's UUID, its node-wide name
GPU_UUID_PREFIX = "GPU-"


def claim_cards(environ) -> list[str]:
    """The GPU UUIDs an NVIDIA claim names in ``CUDA_VISIBLE_DEVICES``
    (empty where it names none).  An index or another form would name a
    card relative to one process's view, which no other claim shares,
    so it is refused."""
    cards = [c.strip() for c in environ.get(ENV_CUDA_VISIBLE, "").split(",")
             if c.strip() != ""]
    odd = [c for c in cards if not c.startswith(GPU_UUID_PREFIX)]
    if odd:
        raise ValueError(
            f"{ENV_CUDA_VISIBLE} entries {odd} are not GPU UUIDs: a "
            f"timeshare lock needs each card's node-wide name")
    return cards


class TimeshareGate:
    """Cooperative per-device time-slicing via flock, for time-sliced
    claims that have no coordinator daemon.

    All claims sharing a chip contend for ``chip<i>.lock``, and all
    claims sharing an NVIDIA card for ``<GPU uuid>.lock``, in the
    node-level timeshare directory (bind-mounted into each of them by
    the per-claim CDI spec).  A holder runs for one preemption quantum,
    releases, and re-contends: flock's queueing gives round-robin-ish
    fairness between cooperating claims, and mutual exclusion is
    kernel-enforced.
    """

    def __init__(self, timeshare_dir: str | Path, chips: list[int],
                 quantum_ms: int, cards: list[str] = ()):
        self.dir = Path(timeshare_dir)
        self.chips = chips
        self.cards = list(cards)
        self.quantum_ms = max(1, quantum_ms)
        self._files: list = []

    @classmethod
    def from_env(cls, environ=None) -> "TimeshareGate | None":
        """The claim's gate, or None where the environment sets no
        timeshare dir or quantum.  The chips of ``TPU_VISIBLE_CHIPS``;
        where that is absent, the cards of ``CUDA_VISIBLE_DEVICES``."""
        env = environ if environ is not None else os.environ
        tdir = env.get(ENV_TIMESHARE_DIR)
        quantum = int(env.get(ENV_PREEMPTION_MS, "0") or 0)
        if not tdir or quantum <= 0:
            return None
        chips = [int(c) for c in env.get(ENV_VISIBLE_CHIPS, "").split(",")
                 if c.strip() != ""]
        cards = [] if ENV_VISIBLE_CHIPS in env else claim_cards(env)
        return cls(tdir, chips, quantum, cards=cards)

    @property
    def lock_names(self) -> list[str]:
        return ([f"chip{chip}.lock" for chip in self.chips]
                + [f"{card}.lock" for card in self.cards])

    def acquire(self) -> None:
        """Block until this claim holds every visible device's lock."""
        self.dir.mkdir(parents=True, exist_ok=True)
        for name in self.lock_names:
            f = open(self.dir / name, "w")
            fcntl.flock(f, fcntl.LOCK_EX)
            self._files.append(f)

    def release(self) -> None:
        for f in self._files:
            fcntl.flock(f, fcntl.LOCK_UN)
            f.close()
        self._files = []

    def turns(self, duration_s: float | None = None):
        """Yield once per held quantum::

            for deadline in gate.turns():
                work_until(deadline)
        """
        end = time.time() + duration_s if duration_s else None
        while end is None or time.time() < end:
            # deadline: waiting for our flock turn is the gate's
            # contract; the holder's quantum bounds it in practice.
            self.acquire()
            try:
                yield time.time() + self.quantum_ms / 1000.0
            finally:
                self.release()


class _ChildGate:
    """SIGSTOP/SIGCONT a child process *group* according to a turn
    oracle.

    The child is spawned with ``start_new_session=True`` (see
    ``_spawn``) so its pid is also its process-group id: signaling the
    group catches workloads that fork — ``sh -c``, launcher scripts,
    ``multiprocessing`` — which a single-pid gate would let escape
    enforcement entirely."""

    def __init__(self, proc: subprocess.Popen):
        self.proc = proc
        self.stopped = False

    def _signal(self, sig: int) -> None:
        try:
            os.killpg(self.proc.pid, sig)
        except (ProcessLookupError, PermissionError):
            try:
                self.proc.send_signal(sig)
            except ProcessLookupError:
                pass

    def allow(self, run: bool) -> None:
        if self.proc.poll() is not None:
            # reap done; still signal the group so forked stragglers
            # of an exited wrapper aren't left frozen
            if not run:
                return
        if run and self.stopped:
            self._signal(signal.SIGCONT)
            self.stopped = False
        elif not run and not self.stopped:
            self._signal(signal.SIGSTOP)
            self.stopped = True

    def resume(self) -> None:
        self.allow(True)


def _spawn(cmd: list[str]) -> subprocess.Popen:
    """Launch the workload in its own session/process group so gating
    and teardown signals reach every process it forks."""
    return subprocess.Popen(cmd, start_new_session=True)


def _teardown(proc: subprocess.Popen) -> None:
    """Terminate the workload's whole group; escalate to SIGKILL."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            proc.terminate()
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            proc.wait()  # deadline: post-SIGKILL reap cannot hang


def _run_coordinated(args, cmd: list[str]) -> int:
    client = CoordinatorClient(args.coordination_dir, name=args.name,
                               weight=args.weight)
    client.wait_ready(args.ready_timeout)
    # Start the child stopped-equivalent: launched, then immediately
    # gated before it can reach the chip out of turn.
    proc = _spawn(cmd)
    client.register(pid=proc.pid, pid_is_group=True)
    gate = _ChildGate(proc)
    gate.allow(False)
    try:
        client.wait_scheduled(args.ready_timeout)
        while proc.poll() is None:
            client.maybe_heartbeat()
            schedule = client.read_schedule()
            now = client._now_ms()
            my_turn = sched.active_worker(schedule, now) == client.name
            gate.allow(my_turn)
            if my_turn:
                wait_ms = sched.ms_left_in_turn(schedule, client.name, now)
            else:
                wait_ms = sched.ms_until_turn(schedule, client.name, now)
            # Re-evaluate at the next boundary (or shortly, if the
            # schedule has no slot for us yet / child may exit).
            delay = 0.02 if not wait_ms else min(wait_ms / 1000.0, 0.25)
            time.sleep(max(delay, 0.001))
        return proc.returncode
    finally:
        gate.resume()                 # never leave a frozen child behind
        _teardown(proc)
        client.unregister()


def _run_timeshared(gate: TimeshareGate, cmd: list[str]) -> int:
    proc = _spawn(cmd)
    child = _ChildGate(proc)
    child.allow(False)
    try:
        while proc.poll() is None:
            # deadline: turn-taking is the point; peers' quanta
            # bound the wait, and a dead peer drops its flock.
            gate.acquire()
            try:
                child.allow(True)
                deadline = time.time() + gate.quantum_ms / 1000.0
                while proc.poll() is None and time.time() < deadline:
                    time.sleep(min(0.01, gate.quantum_ms / 1000.0 / 4))
                child.allow(False)
            finally:
                gate.release()
        return proc.returncode
    finally:
        child.resume()
        _teardown(proc)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m k8s_dra_driver_tpu_torch.coordclient.gate",
        description="Workload-side duty-cycle gate for shared "
                    "TPU and NVIDIA claims")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--coordination-dir",
                        default=os.environ.get(ENV_COORDINATION_DIR),
                        help=f"defaults to ${ENV_COORDINATION_DIR}")
        sp.add_argument("--name",
                        default=os.environ.get("TPU_WORKER_NAME")
                        or os.environ.get("HOSTNAME") or None,
                        help="stable worker identity (default: $HOSTNAME)")
        sp.add_argument("--weight", type=float, default=1.0,
                        help="relative share of the claim's duty cycle")
        sp.add_argument("--ready-timeout", type=float, default=60.0)

    ex = sub.add_parser("exec", help="run a command under the gate")
    common(ex)
    ex.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- command to run")

    wt = sub.add_parser("wait", help="block until our window opens")
    common(wt)

    st = sub.add_parser("status", help="print schedule + whose turn")
    common(st)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.command == "exec":
        cmd = args.cmd
        if cmd and cmd[0] == "--":
            cmd = cmd[1:]
        if not cmd:
            print("gate exec: no command given", file=sys.stderr)
            return 2
        if args.coordination_dir:
            return _run_coordinated(args, cmd)
        ts = TimeshareGate.from_env()
        if ts is not None:
            return _run_timeshared(ts, cmd)
        # Unshared claim: nothing to gate; run the workload untouched.
        return subprocess.call(cmd)

    client = CoordinatorClient(args.coordination_dir, name=args.name,
                               weight=args.weight)
    if args.command == "wait":
        client.register()
        client.wait_ready(args.ready_timeout)
        client.wait_scheduled(args.ready_timeout)
        left = client.wait_turn(args.ready_timeout)
        print(json.dumps({"turn": True, "msLeft": left}))
        return 0

    schedule = client.read_schedule()
    print(json.dumps({
        "schedule": schedule,
        "activeWorker": sched.active_worker(schedule, time.time() * 1000),
        "daemonReady": client.daemon_ready(),
    }, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
