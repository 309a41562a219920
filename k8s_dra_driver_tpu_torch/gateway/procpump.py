"""Multi-process control plane: gateway pumps as real OS processes.

The port of ``k8s_dra_driver_tpu/gateway/procpump.py``: the worker
(``_Worker`` and :func:`main`, started as ``python -m
k8s_dra_driver_tpu_torch.gateway.procpump``) and the conductor
(:class:`ProcessGateway`).  Each pump runs in its own subprocess over
its OWN shard of the replica pool, and the conductor keeps the
``ShardedGateway`` semantics across the process boundary:

- **Prefix-hash sharding + door spill.**  Same crc32-of-prompt-head
  shard map; a full home pump spills to the least-loaded live sibling
  instead of rejecting (reject-on-full means the TIER is full).
- **Work stealing over the wire.**  An idle pump steals the newest
  queued request from the deepest sibling — the request's arrival
  time, deadline, and requeue count travel in the frame
  (gateway/wire.py ``encode_greq``), so a move never grants SLO
  budget.
- **Membership via the coordination directory.**  Workers register
  and heartbeat (coordclient/client.py) from a daemon thread, so a
  wedged worker still heartbeats (alive-but-stuck is detected by RPC
  deadline, not by silence) while a SIGKILLed one goes silent and is
  evicted.
- **Death → drain, across the boundary.**  A dead pump's unfinished
  work requeues at the FRONT of a surviving pump with deadlines
  unchanged, and its terminal outcomes are never lost: every pump
  journals each terminal to the shared
  :class:`~.outcome_store.OutcomeStore` segment BEFORE reporting it,
  so recovery replays the journal and adopts whatever the death
  swallowed (no lost terminal), while the view's first-wins fold
  discards the re-run of anything already committed (no double
  terminal).
- **Deadlines everywhere.**  Every conductor-side wait is a
  classified, deadline-bounded receive (WireTimeout = retry within
  the watchdog budget on a Backoff schedule; WireClosed = the pump is
  gone); a pump that exhausts the watchdog while its heartbeat stays
  fresh is WEDGED and is SIGKILLed into the same drain path.

**On the card.**  Each pump opens the device its ``--device`` names
(default ``cuda``, resolved by utils/device.py: a pump asked for the
card on a machine without one exits with the error), with its own CUDA
context; the conductor passes ``ProcessGateway(device=...)`` to every
worker and, for CPU pumps, sets ``OMP_NUM_THREADS=1`` in the worker
environment so several pumps do not oversubscribe the host's cores.
Workers are started by exec of a fresh interpreter, never by a fork of
a process that has initialized CUDA.  The kernels are loaded from the
library the checkout already built (ops/_build.py); a pump SIGKILLed
on the card takes its context with it, and nothing of the conductor
or the survivors waits on anything it held.  A pump's kernel counters
live in its own process: ``op_stats`` reports them under
``kernel_launches`` (a port-only diagnostic key), and a SIGKILLed
pump's launches are lost with it.

Scheduling, never outcomes: byte-equality holds across the boundary
because every worker builds its weights with :func:`tiny_model` from
the same seed on the same device type, so a requeued victim's re-run
on any surviving pump reproduces the single-engine oracle exactly.
The worker logs to stderr; stdout carries only the tagged frames (an
untagged line there lands in the conductor's noise ring).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from ..cluster.faults import PUMP_KIND, PUMP_VERB
from ..utils.backoff import Backoff
from ..utils.digest import DigestBank
from ..utils.metrics import GatewayMetrics
from .admission import (FINISHED, QUEUED, REJECTED_DUPLICATE,
                        REJECTED_FULL, GatewayRequest)
from .wire import (WireClosed, WireReader, WireTimeout, decode_greq,
                   decode_request, encode_greq, encode_request,
                   parse_frame, send_msg)

#: how often a worker refreshes its coordclient registration
HEARTBEAT_S = 0.5
#: conductor declares a pump dead after this much heartbeat silence
#: (kill-to-eviction latency bound; generous vs HEARTBEAT_S so a GC
#: pause or a slow fsync never evicts a live pump)
WATCHDOG_S = 10.0
#: per-RPC total budget before an unresponsive-but-heartbeating pump
#: is declared wedged and SIGKILLed (a pump's first fill on the card
#: pays context and library warm-up inside this, hence minutes not
#: seconds)
RPC_TIMEOUT_S = 180.0


class PumpDead(ConnectionError):
    """The pump process is gone (EOF/exit) — recovery, not retry."""


class PumpWedged(TimeoutError):
    """The pump is alive but exhausted the RPC watchdog — it gets
    SIGKILLed into the same recovery path as a death."""


# ---------------------------------------------------------------------------
# the worker: one pump process
# ---------------------------------------------------------------------------


#: ``--engine-cfg``'s dtype names (JSON carries strings)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tiny_model(engine_cfg: dict | None, device="cuda"):
    """(cfg, params) of the ``tiny`` engine: the config ``engine_cfg``
    names (``dtype`` as a string, float32 by default), weights from
    ``init_params`` on a generator seeded 0 on ``device``.  The worker
    builds its engines from this, and a caller that holds a pool's
    streams to one engine builds that engine's weights from it too:
    the same function on the same device type gives the same bytes."""
    from ..models import TransformerConfig, init_params
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    cfg_kw = dict(engine_cfg or {})
    cfg_kw["dtype"] = DTYPES[cfg_kw.get("dtype", "float32")]
    cfg = TransformerConfig(**cfg_kw)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    return cfg, params


def _worker_engine_factory(args):
    """Engine factory for this pump's OWN replica shard.  ``tiny``
    builds the transformer of ``--engine-cfg`` with :func:`tiny_model`
    from the SHARED seed — every pump process holds byte-identical
    weights, which is what makes cross-process requeue re-runs
    oracle-equal."""
    if args.engine == "null":
        from .ctlprobe import NullEngine
        return lambda name: NullEngine(
            slots=args.slots, steps_per_request=args.steps_per_request)
    from ..models.serving import ServingEngine
    cfg, params = tiny_model(
        json.loads(args.engine_cfg) if args.engine_cfg else None,
        args.device)
    return lambda name: ServingEngine(params, cfg, slots=args.slots,
                                      device=args.device)


def _parse_args(argv):
    import argparse
    p = argparse.ArgumentParser(prog="procpump")
    p.add_argument("--name", required=True)
    p.add_argument("--ctl-dir", required=True)
    p.add_argument("--store-dir", required=True)
    p.add_argument("--engine", default="null",
                   choices=("null", "tiny"))
    p.add_argument("--engine-cfg", default="")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--steps-per-request", type=int, default=1)
    p.add_argument("--queue-capacity", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--heartbeat-s", type=float, default=HEARTBEAT_S)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


class _Worker:
    """The in-process half of one pump subprocess: a plain
    ``FleetGateway`` over this shard's replicas, driven by framed ops
    on stdin and journaling every terminal durably before it is ever
    reported (the no-lost-terminal half of exactly-once)."""

    def __init__(self, args):
        from ..cluster.bus import BusTap
        from .frontend import FleetGateway
        from .outcome_store import OutcomeStore
        from .replica import ReplicaManager

        self.args = args
        self.name = args.name
        mgr = ReplicaManager(_worker_engine_factory(args),
                             replicas=args.replicas,
                             depth_bound=args.slots)
        self.gw = FleetGateway(mgr,
                               queue_capacity=args.queue_capacity)
        #: pool-level events this pump raises locally, bridged to the
        #: conductor bus in every step reply (cluster/bus.py)
        self.tap = BusTap(self.gw.bus, ("drain", "demand"))
        self.writer = OutcomeStore(args.store_dir).writer(self.name)
        self._reported: set = set()

    # -- membership ------------------------------------------------------

    def start_heartbeat(self):
        import threading

        from ..coordclient.client import CoordinatorClient
        self.coord = CoordinatorClient(self.args.ctl_dir,
                                       name=self.name)
        self.coord.register()
        self._hb_stop = threading.Event()

        def beat():
            while not self._hb_stop.wait(self.args.heartbeat_s):
                try:
                    self.coord.heartbeat()
                except OSError:
                    pass    # a torn ctl dir must not kill the pump

        t = threading.Thread(target=beat, name="pump-heartbeat",
                             daemon=True)
        t.start()

    # -- op handlers -----------------------------------------------------

    def _outcome_entry(self, g) -> dict:
        f = self.gw.results.get(g.uid)
        return {"uid": g.uid, "status": g.status,
                "tokens": (None if f is None
                           else np.asarray(f.tokens).tolist()),
                "n_prompt": 0 if f is None else f.n_prompt,
                "requeues": g.requeues, "pump": self.name}

    def _journal_and_collect(self, done) -> list[dict]:
        """Durably record this round's terminals (ONE fsync), then —
        and only then — hand them to the conductor.  Report-before-
        journal would reopen the lost-terminal window the store
        exists to close."""
        entries = [self._outcome_entry(g) for g in done
                   if g.uid not in self._reported]
        self.writer.record_many(entries)
        self._reported.update(e["uid"] for e in entries)
        return entries

    def op_submit(self, msg) -> dict:
        req = decode_request(msg["req"])
        g = self.gw.submit(req, msg.get("slo_s"),
                           tenant=msg.get("tenant"))
        out = {"status": g.status, "arrival_s": g.arrival_s,
               "deadline_s": g.deadline_s}
        if g.status == QUEUED:
            # uid reuse after a terminal: a fresh lifecycle may reach
            # a fresh terminal, which must journal AGAIN (replay
            # first-wins keeps the earlier record; an identical re-run
            # folds as a benign duplicate).  Unconditional discards so
            # writer.seen can never silently swallow the new terminal.
            self._reported.discard(req.uid)
            self.writer.seen.discard(req.uid)
        # Door refusals are NOT journaled: they travel synchronously
        # in this reply, the uid never enters the conductor's live
        # ledger (so recovery never needs the record), and the
        # conductor may spill the same uid to a sibling — whose later
        # FINISHED would then conflict with a REJECTED_FULL terminal
        # at replay.  Refusals are terminal in the conductor's
        # ``refused`` list, not in the per-uid journal namespace.
        return out

    def op_step(self, msg) -> dict:
        done = []
        for _ in range(msg.get("rounds", 1)):
            done.extend(self.gw.step())
        return {
            "outcomes": self._journal_and_collect(done),
            "depth": len(self.gw.queue),
            "in_flight": sum(len(r.in_flight)
                             for r in self.gw.manager.replicas),
            "admissions_total": self.gw.admissions_total,
            "routes_total": self.gw.routes_total,
            "events": self.tap.drain(),
            "bank": json.loads(self.gw.digests.to_json()),
        }

    def op_steal(self, msg) -> dict:
        g = self.gw.queue.steal_newest()
        return {"greq": None if g is None else encode_greq(g)}

    def op_adopt(self, msg) -> dict:
        self.gw.queue.adopt(decode_greq(msg["greq"]))
        return {"depth": len(self.gw.queue)}

    def op_requeue(self, msg) -> dict:
        """Adopt a dead sibling's victims at the FRONT of this queue,
        FIFO order preserved, deadlines untouched (the drain
        contract, now arriving over the wire)."""
        greqs = [decode_greq(d) for d in msg["greqs"]]
        for g in reversed(greqs):   # appendleft x reversed = FIFO
            self.gw.queue.requeue(g)
            self.gw.metrics.requeued.inc()
        return {"depth": len(self.gw.queue)}

    def op_digests(self, msg) -> dict:
        return {"bank": json.loads(self.gw.digests.to_json())}

    def op_stats(self, msg) -> dict:
        from ..ops import flash_attention as fa
        from ..ops import paged_attention as pa
        st = self.gw.stats()
        st["fsync_count"] = len(self.writer.fsync_ms)
        st["fsync_ms_p50"] = (float(np.median(self.writer.fsync_ms))
                              if self.writer.fsync_ms else 0.0)
        # this process's kernel counters (the conductor cannot read
        # them): K1's normalized entry, its tensor-core share, K2
        st["kernel_launches"] = {"flash_fwd": fa.launches,
                                 "flash_fwd_tc": fa.tc_launches,
                                 "paged_decode": pa.launches}
        return st

    def op_replay(self, msg) -> dict:
        """Closed-loop local drive for the scaling probe: this pump
        generates and pumps its OWN arrival shard, so the conductor
        stays entirely out of the per-request path and the measured
        rate is this process's control-plane throughput.  Reports
        wall AND cpu seconds (``time.process_time``) — on a
        single-core host wall cannot scale with pump count, so the
        honest GIL-escape evidence is decisions per process-cpu-
        second summed across pumps (gateway/procprobe.py)."""
        rng = np.random.default_rng(msg["seed"])
        heads = [rng.integers(0, 1000, 8).astype(np.int32)
                 for _ in range(msg["prefix_families"])]
        tail_n = max(msg["prompt_len"] - 8, 2)

        from ..models.serving import Request
        reqs = []
        for i in range(msg["n"]):
            tail = rng.integers(0, 1000, tail_n).astype(np.int32)
            reqs.append(Request(
                uid=f"{msg['tag']}{i}",
                prompt=np.concatenate([heads[i % len(heads)], tail]),
                max_new=1))
        cap, slo_s = msg["capacity"], msg["slo_s"]
        outcomes: list[dict] = []
        t0, c0 = time.perf_counter(), time.process_time()
        i = 0
        while i < len(reqs):
            while i < len(reqs) and len(self.gw.queue) < cap:
                self.gw.submit(reqs[i], slo_s)
                i += 1
            outcomes.extend(self._journal_and_collect(self.gw.step()))
        for _ in range(200_000):
            if not len(self.gw.queue) and not any(
                    r.in_flight for r in self.gw.manager.replicas):
                break
            outcomes.extend(self._journal_and_collect(self.gw.step()))
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        by_status: dict[str, int] = {}
        for e in outcomes:
            by_status[e["status"]] = by_status.get(e["status"], 0) + 1
        return {"n": len(reqs), "wall_s": wall, "cpu_s": cpu,
                "admissions_total": self.gw.admissions_total,
                "routes_total": self.gw.routes_total,
                "outcomes": by_status,
                "refused": len(self.gw.refused),
                "fsync_ms": list(self.writer.fsync_ms)}

    def op_kv_export(self, msg) -> dict:
        """Prefill this pump's engine for a prompt and ship the KV
        block as host bytes — the cross-process half of the
        disaggregated handoff (serving_disagg/wirekv.py).  ``ms``
        times the export and the encode (port-only diagnostic key)."""
        from ..serving_disagg.wirekv import encode_kv_block
        req = decode_request(msg["req"])
        replica = self.gw.manager.replicas[0]
        t0 = time.perf_counter()
        block = replica.engine.prefill_export(req)
        t1 = time.perf_counter()
        enc = encode_kv_block(block)
        t2 = time.perf_counter()
        return {"block": enc, "ms": {"export": 1e3 * (t1 - t0),
                                     "encode": 1e3 * (t2 - t1)}}

    def op_kv_adopt(self, msg) -> dict:
        """Land a shipped block in this pump's engine and decode it to
        the end; ``ms`` times the decode of the frame onto the device,
        the adoption and the generation (port-only diagnostic key)."""
        from ..serving_disagg.wirekv import decode_kv_block
        replica = self.gw.manager.replicas[0]
        t0 = time.perf_counter()
        block = decode_kv_block(msg["block"],
                                dest=replica.engine.device)
        t1 = time.perf_counter()
        replica.engine.adopt_block(block)
        t2 = time.perf_counter()
        uid = block.request.uid
        for _ in range(10_000):
            finished = replica.engine.step()
            for f in finished:
                if f.uid == uid:
                    t3 = time.perf_counter()
                    return {"tokens": np.asarray(f.tokens).tolist(),
                            "ms": {"decode": 1e3 * (t1 - t0),
                                   "adopt": 1e3 * (t2 - t1),
                                   "generate": 1e3 * (t3 - t2)}}
        raise RuntimeError(f"adopted block {uid!r} never finished")

    # -- the loop --------------------------------------------------------

    def serve(self) -> int:
        out = sys.stdout
        send_msg(out, {"op": "ready", "name": self.name,
                       "pid": os.getpid()})
        # deadline: the worker's command loop blocks on stdin for the
        # process's whole lifetime by design — the conductor owns the
        # pipe, and EOF (conductor death) terminates the loop below.
        for line in sys.stdin:
            msg = parse_frame(line)
            if msg is None:
                continue
            op = msg.get("op", "")
            handler = getattr(self, f"op_{op}", None)
            if handler is None:
                send_msg(out, {"id": msg.get("id"), "ok": False,
                               "error": f"unknown op {op!r}"})
                continue
            if op == "shutdown":
                send_msg(out, {"id": msg.get("id"), "ok": True})
                break
            try:
                reply = handler(msg)
                reply.update(id=msg.get("id"), ok=True)
            except Exception as e:    # report, never die mid-protocol
                reply = {"id": msg.get("id"), "ok": False,
                         "error": f"{type(e).__name__}: {e}"}
            send_msg(out, reply)
        self._hb_stop.set()
        self.coord.unregister()
        self.writer.close()
        return 0

    def op_shutdown(self, msg) -> dict:     # handled inline in serve
        return {}


def main(argv=None) -> int:
    import logging
    logging.basicConfig(stream=sys.stderr, level=logging.WARNING)
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    from ..cluster.faults import install_process_plan, load_plan_from_env
    from ..utils.device import resolve_device
    install_process_plan(load_plan_from_env())
    # a pump asked for the card on a machine without one dies here,
    # with the error on stderr, before it reports ready
    if resolve_device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    w = _Worker(args)
    w.start_heartbeat()
    return w.serve()


# ---------------------------------------------------------------------------
# the conductor
# ---------------------------------------------------------------------------


class _Handle:
    """Conductor-side state for one pump subprocess."""

    def __init__(self, name: str, proc, log_path: Path):
        self.name = name
        self.proc = proc
        self.log_path = log_path
        self.reader = WireReader(proc.stdout, name=name)
        self.live = True
        self.depth = 0
        self.in_flight = 0
        self.admissions_total = 0
        self.routes_total = 0
        self.last_bank: dict | None = None
        self._id = 0

    def next_id(self) -> int:
        self._id += 1
        return self._id


class _LiveView:
    """The conductor's view of not-yet-terminal uids, shaped like an
    AdmissionQueue (what invariant checkers walk)."""

    def __init__(self, live: dict):
        self._live = live

    def uids(self) -> list:
        return sorted(self._live)


class _PoolView:
    """Replica-pool shim for checkers that walk ``manager.replicas``:
    the real replicas live in other processes; what the conductor can
    truthfully expose here is nothing."""

    replicas: tuple = ()


class ProcessGateway:
    """N pump subprocesses behind the ``FleetGateway`` surface
    (``submit`` / ``step`` / ``run_until_idle`` / ``outcomes`` /
    ``results`` / ``refused`` / ``stats``), module docstring for the
    semantics.  ``pending()`` counts every admitted-but-not-terminal
    request (queued OR in flight in some pump) — the conductor cannot
    see inside remote queues between steps, and the conservative
    count is what the replay loops need.

    ``pump_plan`` is a fault plan (cluster/faults.py) consulted once
    per (pump, cycle) under verb ``pump``/kind ``Pump``; a ``crash``
    decision SIGKILLs that pump's process.  ``device`` is every
    worker's ``--device`` (default the card; module docstring).
    """

    def __init__(self, workdir: str | Path, *,
                 workers: int = 2,
                 engine: str = "null",
                 engine_cfg: dict | None = None,
                 replicas: int = 2,
                 slots: int = 8,
                 steps_per_request: int = 1,
                 queue_capacity: int = 64,
                 shard_tokens: int = 8,
                 seed: int = 0,
                 metrics: GatewayMetrics | None = None,
                 bus=None,
                 pump_plan=None,
                 heartbeat_s: float = HEARTBEAT_S,
                 watchdog_s: float = WATCHDOG_S,
                 rpc_timeout_s: float = RPC_TIMEOUT_S,
                 ready_timeout_s: float = 120.0,
                 worker_env: dict | None = None,
                 python: str = sys.executable,
                 device="cuda"):
        from ..cluster.bus import EventBus
        from .outcome_store import OutcomeStore

        if workers < 1:
            raise ValueError("ProcessGateway needs >= 1 worker")
        self.workdir = Path(workdir)
        self.store = OutcomeStore(self.workdir / "outcomes")
        self.ctl_dir = self.workdir / "coord"
        self.log_dir = self.workdir / "logs"
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.metrics = metrics or GatewayMetrics()
        self.bus = bus if bus is not None else EventBus(seed=seed)
        self.pump_plan = pump_plan
        self.shard_tokens = shard_tokens
        self.queue_capacity = queue_capacity
        self.watchdog_s = watchdog_s
        self.rpc_timeout_s = rpc_timeout_s
        self.heartbeat_s = heartbeat_s
        #: uid -> {"worker": name, "greq": encoded record} for every
        #: admitted, not-yet-terminal request — the recovery ledger a
        #: dead pump's victims are requeued from
        self._live: dict = {}
        self.outcomes: dict = {}
        self.results: dict = {}
        self.refused: list = []
        self.queue = _LiveView(self._live)
        self.manager = _PoolView()
        self.admissions_total = 0
        self.routes_total = 0
        self.steals_total = 0
        self.pump_deaths = 0
        self.duplicates_discarded = 0
        self.adopted_from_journal = 0
        self._steps = 0
        #: digest banks of DEAD pumps, retained so merged quantiles
        #: never silently lose a dead pump's samples
        self._dead_banks: dict = {}
        self.handles: list[_Handle] = []
        args_common = [
            "--ctl-dir", str(self.ctl_dir),
            "--store-dir", str(self.workdir / "outcomes"),
            "--engine", engine,
            "--replicas", str(replicas), "--slots", str(slots),
            "--steps-per-request", str(steps_per_request),
            "--queue-capacity", str(queue_capacity),
            "--seed", str(seed),
            "--heartbeat-s", str(heartbeat_s),
            "--device", str(device)]
        if engine_cfg:
            args_common += ["--engine-cfg", json.dumps(engine_cfg)]
        env = dict(os.environ)
        # the package's checkout, whatever the caller's cwd
        root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        if torch.device(device).type == "cpu":
            # one intra-op thread a pump: N pumps share the host's
            # cores instead of each spreading over all of them
            env["OMP_NUM_THREADS"] = "1"
        env.update(worker_env or {})
        for i in range(workers):
            name = f"pump{i}"
            log_path = self.log_dir / f"{name}.log"
            log_f = open(log_path, "w")
            proc = subprocess.Popen(
                [python, "-m",
                 "k8s_dra_driver_tpu_torch.gateway.procpump",
                 "--name", name] + args_common,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=log_f, text=True, env=env)
            log_f.close()
            self.handles.append(_Handle(name, proc, log_path))
        try:
            for h in self.handles:
                self._await_ready(h, ready_timeout_s)
        except BaseException:
            # a pump that never came up: stop every one started
            self.close()
            raise
        self.metrics.pumps.set(workers)
        self.metrics.add_digest_source(self.merged_digests)

    # -- lifecycle -------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _await_ready(self, h: _Handle, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"pump {h.name} not ready in {timeout_s}s; "
                    f"log tail:\n{self._log_tail(h)}")
            try:
                msg = h.reader.recv(min(left, 1.0))
            except WireTimeout:
                if h.proc.poll() is not None:
                    raise PumpDead(
                        f"pump {h.name} exited rc={h.proc.returncode}"
                        f" before ready; log tail:\n"
                        f"{self._log_tail(h)}") from None
                continue
            except WireClosed:
                raise PumpDead(
                    f"pump {h.name} closed the pipe before ready; "
                    f"log tail:\n{self._log_tail(h)}") from None
            if msg.get("op") == "ready":
                return

    def _log_tail(self, h: _Handle, n: int = 15) -> str:
        try:
            lines = h.log_path.read_text().splitlines()
        except OSError:
            lines = []
        return "\n".join(lines[-n:] + list(h.reader.noise))

    def close(self) -> None:
        """Graceful-then-forceful shutdown (the oopbed discipline)."""
        for h in self.handles:
            if not h.live or h.proc.poll() is not None:
                continue
            try:
                send_msg(h.proc.stdin,
                         {"id": h.next_id(), "op": "shutdown"})
            except (OSError, ValueError):
                pass
        for h in self.handles:
            if h.proc.poll() is None:
                try:
                    h.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    h.proc.kill()
                    try:
                        h.proc.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        pass
            if h.proc.stdin is not None:
                try:
                    h.proc.stdin.close()
                except OSError:
                    pass

    # -- RPC -------------------------------------------------------------

    def _rpc(self, h: _Handle, op: str, timeout_s: float | None = None,
             **fields) -> dict:
        """One framed request/response with the classified-retry
        discipline: WireTimeout retries on the Backoff schedule until
        the RPC watchdog budget is spent (then the pump is WEDGED);
        WireClosed is immediately fatal (the pump is DEAD).  Both
        raise — the CALLER routes them into ``_recover``."""
        if not h.live:
            raise PumpDead(f"pump {h.name} is not live")
        msg_id = h.next_id()
        try:
            send_msg(h.proc.stdin, dict(fields, id=msg_id, op=op))
        except (OSError, ValueError) as e:
            raise PumpDead(f"pump {h.name} pipe write failed: {e}")
        budget = timeout_s if timeout_s is not None \
            else self.rpc_timeout_s
        deadline = time.monotonic() + budget
        bo = Backoff(duration_s=0.05, factor=2.0, jitter=0.0,
                     steps=64, cap_s=1.0, deadline_s=budget)
        delays = iter(list(bo.delays()) + [bo.cap_s] * 10_000)
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise PumpWedged(
                    f"pump {h.name}: no reply to {op!r} within "
                    f"{budget}s (heartbeat may still be fresh — "
                    f"wedged, not dead)")
            try:
                reply = h.reader.recv(min(next(delays), left))
            except WireTimeout:
                if h.proc.poll() is not None:
                    raise PumpDead(
                        f"pump {h.name} exited rc="
                        f"{h.proc.returncode} during {op!r}") from None
                continue
            except WireClosed:
                raise PumpDead(
                    f"pump {h.name} closed the pipe during "
                    f"{op!r}") from None
            if reply.get("id") != msg_id:
                continue    # stale frame from a pre-recovery exchange
            if not reply.get("ok"):
                raise RuntimeError(
                    f"pump {h.name} op {op!r} failed: "
                    f"{reply.get('error')}")
            return reply

    # -- intake ----------------------------------------------------------

    def _shard(self, prompt) -> int:
        arr = np.asarray(prompt, np.int32)
        head = arr[:max(min(self.shard_tokens, arr.size - 1), 1)]
        return zlib.crc32(head.tobytes()) % len(self.handles)

    def _live_handles(self) -> list[_Handle]:
        return [h for h in self.handles if h.live]

    def submit(self, req, slo_s: float | None = None, *,
               tenant: str | None = None) -> GatewayRequest:
        """Admit into the prompt's home pump (door-spilling a full or
        dead home to the least-loaded live sibling) or refuse with
        the explicit status.  The duplicate contract spans processes:
        the conductor's live ledger is the pool-wide uid set."""
        self.admissions_total += 1
        if req.uid in self._live:
            g = GatewayRequest(request=req, arrival_s=0.0,
                               deadline_s=0.0,
                               status=REJECTED_DUPLICATE,
                               tenant=tenant)
            self.refused.append(g)
            self.metrics.requests.labels(
                outcome=REJECTED_DUPLICATE).inc()
            return g
        # uid reuse after a terminal outcome starts a fresh lifecycle
        # (the FleetGateway.submit rule)
        self.outcomes.pop(req.uid, None)
        self.results.pop(req.uid, None)
        alive = self._live_handles()
        if not alive:
            raise RuntimeError("no live pumps")
        home = self.handles[self._shard(req.prompt)]
        target = home
        if not home.live or home.depth >= self.queue_capacity:
            target = min(alive, key=lambda h: (h.depth, h.name))
        for attempt in range(2):
            reply = self._rpc(target, "submit",
                              req=encode_request(req), slo_s=slo_s,
                              tenant=tenant)
            status = reply["status"]
            if status != REJECTED_FULL:
                break
            others = [h for h in self._live_handles()
                      if h is not target]
            if not others:
                break
            target = min(others, key=lambda h: (h.depth, h.name))
        g = GatewayRequest(request=req,
                           arrival_s=reply["arrival_s"],
                           deadline_s=reply["deadline_s"],
                           status=status, tenant=tenant)
        if status == QUEUED:
            target.depth += 1
            self._live[req.uid] = {
                "worker": target.name,
                "greq": {"request": encode_request(req),
                         "arrival_s": g.arrival_s,
                         "deadline_s": g.deadline_s,
                         "requeues": 0, "tenant": tenant}}
        else:
            self.refused.append(g)
            self.metrics.requests.labels(outcome=status).inc()
        return g

    # -- the cycle -------------------------------------------------------

    def step(self) -> list[GatewayRequest]:
        """One conductor cycle: membership (+ scripted pump kills) →
        recover the dead → step every live pump → fold outcomes/
        events → work-steal → gauges."""
        done: list[GatewayRequest] = []
        self._check_membership()
        for h in self._live_handles():
            try:
                reply = self._rpc(h, "step", rounds=1)
            except (PumpDead, PumpWedged) as e:
                self._kill(h, reason=str(e))
                self._recover(h)
                continue
            h.depth = reply["depth"]
            h.in_flight = reply["in_flight"]
            h.admissions_total = reply["admissions_total"]
            h.routes_total = reply["routes_total"]
            h.last_bank = reply["bank"]
            for topic, payload in reply["events"]:
                self._bridge_event(h, topic, payload)
            for entry in reply["outcomes"]:
                g = self._fold_outcome(entry)
                if g is not None:
                    done.append(g)
        self._work_steal()
        self.metrics.queue_depth.set(
            sum(h.depth for h in self._live_handles()))
        self.metrics.pumps.set(len(self._live_handles()))
        self.bus.pump()
        self._steps += 1
        return done

    def run_until_idle(self, max_steps: int = 10_000) -> list:
        out: list = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self._live:
                return out
        raise RuntimeError(f"gateway not idle after {max_steps} steps")

    def pending(self) -> int:
        """Admitted-but-not-terminal count (class docstring)."""
        return len(self._live)

    # -- membership + recovery -------------------------------------------

    def _heartbeat_age_s(self, h: _Handle) -> float:
        path = self.ctl_dir / "ctl" / f"{h.name}.json"
        try:
            reg = json.loads(path.read_text())
        except (OSError, ValueError):
            return float("inf")
        at = reg.get("heartbeatAtMs") or reg.get("registeredAtMs")
        if at is None:
            return float("inf")
        return max(time.time() - at / 1000.0, 0.0)

    def _check_membership(self) -> None:
        for h in self._live_handles():
            if self.pump_plan is not None:
                d = self.pump_plan.decide(PUMP_VERB, PUMP_KIND, h.name)
                if d is not None and d.error == "crash":
                    self._kill(h, reason="scripted pump_kill")
                    self._recover(h)
                    continue
            if h.proc.poll() is not None:
                h.live = False
                self._recover(h)
            elif self._heartbeat_age_s(h) > self.watchdog_s:
                # silent past the watchdog: the heartbeat thread is
                # daemon-simple, so silence means the PROCESS is gone
                # or stopped — either way it no longer owns its work
                self._kill(h, reason="heartbeat silence")
                self._recover(h)

    def _kill(self, h: _Handle, reason: str = "") -> None:
        h.live = False
        if h.proc.poll() is None:
            try:
                os.kill(h.proc.pid, signal.SIGKILL)
            except (OSError, ProcessLookupError):
                pass
            try:
                h.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        self.bus.publish("pump_kill", pump=h.name, reason=reason)

    def _recover(self, h: _Handle) -> None:
        """The cross-process drain: adopt journaled terminals the
        death swallowed, requeue everything else at a survivor's
        queue FRONT with deadlines unchanged, retain the dead pump's
        digest bank for render-time merging."""
        h.live = False
        self.pump_deaths += 1
        self.metrics.drains.inc()
        if h.last_bank is not None:
            self._dead_banks[h.name] = h.last_bank
        view = self.store.replay(segment=h.name)
        victims = []
        for uid, info in list(self._live.items()):
            if info["worker"] != h.name:
                continue
            entry = view.terminals.get(uid)
            if entry is not None:
                # journaled before death, never reported: adopt it —
                # the no-lost-terminal half of the store contract
                self._fold_outcome(entry)
                self.adopted_from_journal += 1
            else:
                victims.append((info["greq"]["arrival_s"], uid, info))
        victims.sort(key=lambda t: (t[0], str(t[1])))
        while victims:
            survivors = self._live_handles()
            if not survivors:
                raise RuntimeError(
                    f"pump {h.name} died with {len(victims)} "
                    f"requests and no live pump remains")
            target = min(survivors, key=lambda s: (s.depth, s.name))
            greqs = [info["greq"] for _, _, info in victims]
            try:
                reply = self._rpc(target, "requeue", greqs=greqs)
            except (PumpDead, PumpWedged) as e:
                # the chosen survivor died mid-recovery: recover IT
                # (cascading deaths fold, victims stay ours) and pick
                # the next survivor
                self._kill(target, reason=str(e))
                self._recover(target)
                continue
            target.depth = reply["depth"]
            for _, uid, info in victims:
                info["worker"] = target.name
                self.metrics.requeued.inc()
            break
        self.bus.publish("drain", pump=h.name,
                         requeued=len(victims))
        self.metrics.pumps.set(len(self._live_handles()))

    # -- folds -----------------------------------------------------------

    def _fold_outcome(self, entry: dict) -> GatewayRequest | None:
        """One terminal entry (wire report or journal replay) into
        the conductor's exactly-once surface; duplicates — a victim
        whose first terminal was already adopted — are DISCARDED and
        counted, never double-recorded."""
        uid = entry["uid"]
        if uid in self.outcomes:
            self.duplicates_discarded += 1
            return None
        info = self._live.pop(uid, None)
        greq = (info or {}).get("greq")
        req = (decode_request(greq["request"]) if greq
               else None)
        g = GatewayRequest(
            request=req if req is not None else _StubRequest(uid),
            arrival_s=greq["arrival_s"] if greq else 0.0,
            deadline_s=greq["deadline_s"] if greq else 0.0,
            status=entry["status"], requeues=entry.get("requeues", 0),
            tenant=(greq or {}).get("tenant"))
        self.outcomes[uid] = g
        if entry["status"] == FINISHED and entry.get("tokens") \
                is not None:
            from ..models.serving import Finished
            self.results[uid] = Finished(
                uid=uid,
                tokens=np.asarray(entry["tokens"], np.int32),
                n_prompt=entry.get("n_prompt", 0))
        self.metrics.requests.labels(outcome=entry["status"]).inc()
        return g

    def _bridge_event(self, h: _Handle, topic: str,
                      payload: dict) -> None:
        """Republish a pump-local bus event fleet-wide, tagged with
        its pump — the conductor bus is where fleet observers
        (reconciler, flight recorder) subscribe."""
        payload = {k: v for k, v in payload.items() if k != "pump"}
        self.bus.publish(topic, pump=h.name, **payload)
        if topic == "drain":
            self.metrics.drains.inc()
            n = payload.get("requeued", 0)
            if n:
                self.metrics.requeued.inc(n)

    def _work_steal(self) -> None:
        """Idle pumps pull the newest queued request off the deepest
        live sibling, over the wire; FIFO heads and requeued victims
        never move (AdmissionQueue.steal_newest).  Both RPC legs are
        death-classified like every other conductor wait: a donor
        dying mid-steal folds into the normal recovery, and a thief
        dying AFTER the donor handed the request over — the one
        window where a request is queued on no pump and ``_live``
        still blames the donor — is recovered and the orphan
        explicitly re-homed (:meth:`_rehome`)."""
        while True:
            alive = self._live_handles()
            if len(alive) < 2:
                return
            hungry = [h for h in alive if h.depth == 0]
            donor = max(alive, key=lambda h: h.depth)
            if not hungry or donor.depth <= 1:
                return
            thief = hungry[0]
            try:
                reply = self._rpc(donor, "steal")
            except (PumpDead, PumpWedged) as e:
                self._kill(donor, reason=str(e))
                self._recover(donor)
                continue
            if reply["greq"] is None:
                donor.depth = 0
                continue
            donor.depth -= 1
            greq = reply["greq"]
            uid = greq["request"]["uid"]
            try:
                adopt = self._rpc(thief, "adopt", greq=greq)
            except (PumpDead, PumpWedged) as e:
                self._kill(thief, reason=str(e))
                self._recover(thief)
                self._rehome(uid, greq)
                continue
            thief.depth = adopt["depth"]
            if uid in self._live:
                self._live[uid]["worker"] = thief.name
                self._live[uid]["greq"] = greq
            self.steals_total += 1
            self.metrics.steals.inc()

    def _rehome(self, uid, greq: dict) -> None:
        """Re-home a request that left its donor but never reached
        its thief: until it is requeued somewhere it exists only in
        ``greq``, and ``_live`` still records the donor as owner —
        so the thief's recovery pass cannot see it.  Requeued at a
        survivor's FRONT with scheduling state unchanged (the drain
        contract: the move grants no SLO budget)."""
        if uid not in self._live:
            return      # reached a terminal via the recovery replay
        while True:
            survivors = self._live_handles()
            if not survivors:
                raise RuntimeError(
                    f"request {uid!r} orphaned mid-steal with no "
                    f"live pump remaining")
            target = min(survivors, key=lambda s: (s.depth, s.name))
            try:
                reply = self._rpc(target, "requeue", greqs=[greq])
            except (PumpDead, PumpWedged) as e:
                self._kill(target, reason=str(e))
                self._recover(target)
                continue
            target.depth = reply["depth"]
            self._live[uid]["worker"] = target.name
            self._live[uid]["greq"] = greq
            self.metrics.requeued.inc()
            return

    # -- observability ---------------------------------------------------

    def merged_digests(self) -> DigestBank:
        """Fleet quantiles across pump PROCESSES: live pumps' last-
        reported banks merged with the retained banks of dead pumps —
        a pump dying must narrow the fleet's future samples, never
        erase its past ones."""
        banks = []
        for h in self.handles:
            raw = h.last_bank if h.live else \
                self._dead_banks.get(h.name, h.last_bank)
            if raw:
                banks.append(_bank_from_json(raw))
        return DigestBank.merged(banks)

    def stats(self) -> dict:
        by_status: dict[str, int] = {}
        for g in self.outcomes.values():
            by_status[g.status] = by_status.get(g.status, 0) + 1
        for g in self.refused:
            by_status[g.status] = by_status.get(g.status, 0) + 1
        return {
            "pumps": len(self.handles),
            "pumps_live": len(self._live_handles()),
            "pump_deaths": self.pump_deaths,
            "queued_per_pump": {h.name: h.depth
                                for h in self._live_handles()},
            "pending": self.pending(),
            "steps": self._steps,
            "steals": self.steals_total,
            "outcomes": by_status,
            "duplicates_discarded": self.duplicates_discarded,
            "adopted_from_journal": self.adopted_from_journal,
        }


class _StubRequest:
    """Placeholder when a journal entry outlived its request bytes
    (conductor restart): uid-only, enough for accounting."""

    def __init__(self, uid):
        self.uid = uid
        self.prompt = np.zeros(1, np.int32)
        self.max_new = 1


def _bank_from_json(raw: dict) -> DigestBank:
    from ..utils.digest import QuantileDigest
    bank = DigestBank()
    for name, d in raw.items():
        bank.digests[name] = QuantileDigest.from_json(json.dumps(d))
    return bank


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["ProcessGateway", "PumpDead", "PumpWedged", "main"]
