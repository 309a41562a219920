"""Host-dispatch accounting for the serving/decode path.

Every launch site of the port's decode and serving layers
(models/decode.py, models/serving.py) is wrapped with :func:`counted`,
which increments a process-global counter per call, under the same
labels the JAX package uses, so the two engines' launch accounting can
be compared label by label.  In eager PyTorch a "dispatch" is one
call of a counted host function (which itself enqueues many device
kernels); the counter measures host-side program structure, not
device kernel launches.  The kernels' own launch counts live on their
wrappers (ops/flash_attention.py, ops/paged_attention.py, ops/gmm.py,
models/quant.py).

Blocking device->host readbacks (``.cpu()``/``int()`` on device
values) are recorded separately via :func:`record_readback`.

With :func:`enable_annotations` on, every counted call also runs inside
a ``torch.profiler`` range named by its label
(utils/profiling.py :func:`~.profiling.annotate`), and
:func:`annotated` names a multi-launch host phase the same way, so a
trace taken with ``profiling.trace`` shows which launch site enqueued
each kernel.  Off by default: a range costs a profiler call a launch.

Scoping: the counter is process-global.  Measurements use
:func:`track`, which snapshots deltas, so interleaved engines in one
process must not run concurrently during a tracked region.
"""

from __future__ import annotations

import contextlib
import threading


class DispatchCounter:
    """Process-global launch/readback tallies, by label."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.dispatches = 0
        self.readbacks = 0
        self.by_label: dict[str, int] = {}

    def record(self, label: str, n: int = 1) -> None:
        with self._lock:
            self.dispatches += n
            self.by_label[label] = self.by_label.get(label, 0) + n

    def record_readback(self, label: str) -> None:
        with self._lock:
            self.readbacks += 1
            key = f"readback:{label}"
            self.by_label[key] = self.by_label.get(key, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"dispatches": self.dispatches,
                    "readbacks": self.readbacks,
                    "by_label": dict(self.by_label)}


#: the process-global counter every wrapped launch site feeds
COUNTER = DispatchCounter()

#: when True, every counted launch site also wraps its call in a
#: ``torch.profiler`` range named by its dispatch label, so a trace
#: shows which launch site enqueued each kernel.  Off by default: the
#: tests and the hot paths must not pay a profiler call a launch.
ANNOTATE = False


def enable_annotations(on: bool = True) -> None:
    """Flip the launch-site ranges on (or off)."""
    global ANNOTATE
    ANNOTATE = on


def annotated(label: str):
    """Context for a multi-launch host phase (a chunked prefill, an
    export): a ``torch.profiler`` range when annotations are on, a
    ``nullcontext`` (no profiler call) when off."""
    if not ANNOTATE:
        return contextlib.nullcontext()
    from . import profiling
    return profiling.annotate(label)


class Tracked:
    """Delta view filled in when a :func:`track` region closes."""

    def __init__(self) -> None:
        self.dispatches = 0
        self.readbacks = 0
        self.by_label: dict[str, int] = {}


@contextlib.contextmanager
def track():
    """``with dispatch.track() as t: ...`` — ``t.dispatches`` /
    ``t.readbacks`` / ``t.by_label`` hold the region's deltas."""
    before = COUNTER.snapshot()
    t = Tracked()
    try:
        yield t
    finally:
        after = COUNTER.snapshot()
        t.dispatches = after["dispatches"] - before["dispatches"]
        t.readbacks = after["readbacks"] - before["readbacks"]
        t.by_label = {
            k: v - before["by_label"].get(k, 0)
            for k, v in after["by_label"].items()
            if v - before["by_label"].get(k, 0)}


class Aggregator:
    """Accumulate :func:`track` deltas under coarse keys: the fleet
    gateway runs each replica's engine step inside its own ``track()``
    region (its pump is single-threaded) and folds the delta in under
    the replica's name.  ``snapshot()`` has DispatchCounter's shape per
    key."""

    def __init__(self) -> None:
        self.by_key: dict[str, Tracked] = {}

    def add(self, key: str, t: Tracked) -> None:
        agg = self.by_key.setdefault(key, Tracked())
        agg.dispatches += t.dispatches
        agg.readbacks += t.readbacks
        for label, n in t.by_label.items():
            agg.by_label[label] = agg.by_label.get(label, 0) + n

    def snapshot(self) -> dict[str, dict]:
        return {k: {"dispatches": t.dispatches,
                    "readbacks": t.readbacks,
                    "by_label": dict(t.by_label)}
                for k, t in self.by_key.items()}


class _Counted:
    """Callable wrapper that counts calls and forwards everything
    else to the wrapped function."""

    def __init__(self, label: str, fn) -> None:
        self._label = label
        self._fn = fn
        self.__doc__ = getattr(fn, "__doc__", None)
        self.__name__ = label

    def __call__(self, *args, **kwargs):
        COUNTER.record(self._label)
        if ANNOTATE:
            from . import profiling
            with profiling.annotate(self._label):
                return self._fn(*args, **kwargs)
        return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)


def counted(label: str):
    """Decorator: count each call of ``fn`` as one host dispatch."""
    def wrap(fn):
        return _Counted(label, fn)
    return wrap


def record(label: str, n: int = 1) -> None:
    COUNTER.record(label, n)


def record_readback(label: str) -> None:
    COUNTER.record_readback(label)
