"""Wire codecs + deadline-bounded line transport for pump processes.

The port of ``k8s_dra_driver_tpu/gateway/wire.py``.  The multi-process
gateway (gateway/procpump.py) moves three kinds of state across a
process boundary: requests (door spill and dispatch), gateway records
(drain requeue and work stealing, where arrival time, deadline and
requeue count MUST travel with the request: surviving a drain grants
no SLO budget), and finished outcomes.  This module is the single
place their byte layout lives, plus the transport discipline every
cross-process wait obeys:

- **Framing.**  One JSON object per line, tagged ``@wire `` so stray
  writes to the worker's stdout (a library warning, a stale print)
  can never desynchronize the protocol — untagged lines are
  diagnostics, kept in a ring for the death report.
- **Deadline-bounded receive.**  A daemon reader thread drains the
  pipe into a queue; :meth:`WireReader.recv` waits on the queue with a
  timeout and classifies the failure: :class:`WireTimeout` (the peer
  is slow or wedged — retryable within the caller's watchdog budget)
  vs :class:`WireClosed` (EOF: the peer is GONE — never retried).

Arrays ride as base64 of raw little-endian bytes with dtype + shape
(no pickle: the conductor must never execute bytes a dying worker
wrote).  Every dtype numpy names keeps the reference's tag
(``a.dtype.str``: ``"<i4"``, ``"<u4"``, ``"<f4"``...), so those frames
are byte-equal to the reference's and decode in either package.
``encode_array`` takes a numpy array or a torch tensor; a tensor on
the card is copied to the host with ``.cpu()``.  bfloat16, the card's
serving dtype, has no numpy name: a bf16 tensor rides as its raw
little-endian 16-bit patterns under the tag ``"bfloat16"`` and decodes
to a ``torch.bfloat16`` tensor.  (The reference writes an ``ml_dtypes``
bfloat16 array's ``dtype.str``, ``"<V2"``, which decodes to a void
array nothing can use.)  ``inf`` deadlines survive JSON because both
ends are Python (``Infinity`` literals).
"""

from __future__ import annotations

import base64
import json
import queue
import threading
from collections import deque

import numpy as np
import torch

TAG = "@wire "

#: the dtype tag of a bf16 tensor's frame (its raw 16-bit patterns)
BF16_TAG = "bfloat16"

#: diagnostics ring: last untagged lines from a peer, surfaced when it
#: dies
_NOISE_KEEP = 30


class WireTimeout(TimeoutError):
    """No frame within the deadline: peer slow or wedged — RETRYABLE
    (the caller's watchdog decides when slow becomes dead)."""


class WireClosed(ConnectionError):
    """Pipe EOF: the peer process is gone — FATAL, never retried."""


# -- array + message codecs (host bytes only, no pickle) ---------------


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode("ascii")


def encode_array(a) -> dict:
    """A numpy array or a torch tensor (any device) as a frame dict."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().astype("<i2", copy=False)
            return {"dtype": BF16_TAG, "shape": list(t.shape),
                    "b64": _b64(bits.tobytes())}
        a = t.numpy()
    a = np.ascontiguousarray(a)
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "b64": _b64(a.tobytes())}


def decode_array(d: dict):
    """A numpy array, or a ``torch.bfloat16`` tensor for the bf16
    tag."""
    raw = base64.b64decode(d["b64"])
    if d["dtype"] == BF16_TAG:
        bits = np.frombuffer(raw, dtype="<i2").astype(np.int16)
        return torch.from_numpy(bits.reshape(d["shape"])).view(
            torch.bfloat16)
    a = np.frombuffer(raw, dtype=np.dtype(d["dtype"]))
    return a.reshape(d["shape"]).copy()


def encode_request(req) -> dict:
    return {"uid": req.uid, "prompt": encode_array(req.prompt),
            "max_new": req.max_new, "eos_id": req.eos_id,
            "temperature": req.temperature, "seed": req.seed}


def decode_request(d: dict):
    from ..models.serving import Request
    return Request(uid=d["uid"], prompt=decode_array(d["prompt"]),
                   max_new=d["max_new"], eos_id=d["eos_id"],
                   temperature=d["temperature"], seed=d["seed"])


def encode_greq(g) -> dict:
    """A gateway record crossing shards: the request plus exactly the
    scheduling state that must survive the move — arrival/deadline
    (unchanged SLO budget), requeue count, tenant.  The trace cursor
    does NOT cross (spans are per-process)."""
    return {"request": encode_request(g.request),
            "arrival_s": g.arrival_s, "deadline_s": g.deadline_s,
            "requeues": g.requeues, "tenant": g.tenant}


def decode_greq(d: dict):
    from .admission import QUEUED, GatewayRequest
    return GatewayRequest(request=decode_request(d["request"]),
                          arrival_s=d["arrival_s"],
                          deadline_s=d["deadline_s"], status=QUEUED,
                          requeues=d["requeues"], tenant=d["tenant"])


def encode_finished(f) -> dict:
    return {"uid": f.uid, "tokens": encode_array(f.tokens),
            "n_prompt": f.n_prompt}


def decode_finished(d: dict):
    from ..models.serving import Finished
    return Finished(uid=d["uid"],
                    tokens=decode_array(d["tokens"]).astype(np.int32),
                    n_prompt=d["n_prompt"])


# -- framing -----------------------------------------------------------


def send_msg(stream, msg: dict) -> None:
    """One tagged frame; flush so a one-line exchange never deadlocks
    on buffering."""
    stream.write(TAG + json.dumps(msg) + "\n")
    stream.flush()


def parse_frame(line: str) -> dict | None:
    """The frame's payload, or None for diagnostics/noise lines."""
    if not line.startswith(TAG):
        return None
    try:
        msg = json.loads(line[len(TAG):])
    except ValueError:
        return None
    return msg if isinstance(msg, dict) else None


class WireReader:
    """Deadline-bounded reads over a pipe, via a daemon drain thread.

    The thread is the only place a blocking ``readline`` exists; it
    dies with the pipe (EOF → sentinel) and is never joined — the
    process owns its lifetime.
    """

    def __init__(self, stream, name: str = "wire"):
        self._q: queue.Queue = queue.Queue()
        self.noise: deque = deque(maxlen=_NOISE_KEEP)
        self._t = threading.Thread(
            target=self._drain, args=(stream,),
            name=f"wire-reader-{name}", daemon=True)
        self._t.start()

    def _drain(self, stream) -> None:
        # the drain thread's readline blocks for the pipe's whole
        # lifetime by design; EOF posts the closing sentinel and every
        # consumer-side wait is deadline-bounded in recv()
        for line in stream:
            msg = parse_frame(line)
            if msg is None:
                self.noise.append(line.rstrip("\n"))
            else:
                self._q.put(msg)
        self._q.put(None)   # EOF sentinel: the peer is gone

    def recv(self, timeout_s: float) -> dict:
        """Next frame, or a CLASSIFIED failure (module docstring)."""
        try:
            msg = self._q.get(timeout=timeout_s)
        except queue.Empty:
            raise WireTimeout(
                f"no frame within {timeout_s}s") from None
        if msg is None:
            raise WireClosed("peer closed the pipe")
        return msg

    def noise_tail(self) -> str:
        return "\n".join(self.noise)


__all__ = ["BF16_TAG", "TAG", "WireClosed", "WireReader", "WireTimeout",
           "decode_array", "decode_finished", "decode_greq",
           "decode_request", "encode_array", "encode_finished",
           "encode_greq", "encode_request", "parse_frame", "send_msg"]
