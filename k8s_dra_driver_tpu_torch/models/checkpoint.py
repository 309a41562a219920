"""Training checkpoint/resume in a torch-native format.

The port of ``k8s_dra_driver_tpu/models/checkpoint.py``
(``TrainCheckpointer``), same API, without orbax: a generation is a
directory ``<directory>/<step>/`` holding ``params.pt`` (``{dotted
path: tensor}``, the order of ``named_tensors``), ``opt_state.pt`` (the
optimizer's ``state_dict()``) and ``extra.json`` (the small JSON
sidecar, e.g. the data loader's ``state_dict()``), all on the CPU.

- **Atomic + versioned.**  Each generation is written into a temp
  directory beside the others, its files fsynced, then renamed into
  place and the parent fsynced (``utils/atomicio.py``); ``keep``
  generations are retained and the newest is discovered, so a restarted
  job just calls ``restore(params, opt_state)``.
- **Verify on restore.**  Each committed generation gets a crc32
  sidecar ``<directory>-integrity/<step>.json`` in the JAX package's
  format ``tpu-dra-ckpt-integrity/1``; restore checks every recorded
  file before parsing it.  ``restore(step=None)`` falls back
  newest-first past a torn or corrupt generation; an explicit
  ``step=`` stays strict.
- **Asynchronous write.**  ``save`` copies the state to host memory
  before it returns; with ``wait=False`` the files are written by a
  background thread while training goes on.  The next ``save``,
  ``restore`` or ``close`` waits for it.
- **Already-saved steps.**  Saving a step that has a committed
  generation returns without writing and keeps the first generation's
  bytes and ``extra``, as orbax does: a step replayed after a restore,
  or saved again by a resize or park that lands on a checkpoint step,
  recomputes the saved state.
- **Crashpoints.**  ``cluster/faults.py``'s ``train_ckpt.saving`` fires
  with the write in flight (files in the temp directory, before the
  rename: the generation never appears) and ``train_ckpt.committed``
  after the rename and the directory fsync, before the integrity
  sidecar (the generation verifies trivially, as one written before
  sidecars existed).

The sharded, per-leaf format of the reference (``tpu-dra-sharded-ckpt/1``)
is ``parallel/resharding.py``'s ``ShardedCheckpointer``, with the same
API; ``ShardCorruption`` is its.
"""

from __future__ import annotations

import io
import json
import logging
import os
import shutil
import tempfile
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any

import torch

from ..cluster import faults
from ..parallel.resharding import ShardCorruption
from ..utils import atomicio
from .transformer import named_tensors

log = logging.getLogger(__name__)

INTEGRITY_FORMAT = "tpu-dra-ckpt-integrity/1"
_PARAMS, _OPT, _EXTRA = "params.pt", "opt_state.pt", "extra.json"


def _crc32_file(path: Path) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _to_cpu(obj):
    """A copy of ``obj`` (dicts, lists, tuples, tensors, scalars) with
    every tensor detached and copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _serialized(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


class TrainCheckpointer:
    """Save/restore (params, opt_state, step) under one directory.

    ``params`` is a parameter tree (dicts and lists of tensors) and
    ``opt_state`` a ``torch.optim.Optimizer`` bound to its leaves, as
    ``make_train_step``'s ``init_state`` returns them."""

    def __init__(self, directory: str | Path, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = Path(directory).absolute()
        self.keep = keep
        self._integrity = self.directory.with_name(
            self.directory.name + "-integrity")
        self.directory.mkdir(parents=True, exist_ok=True)
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending: Future | None = None

    # -- save -----------------------------------------------------------

    def save(self, step: int, params: Any, opt_state: Any,
             wait: bool = True, extra: dict | None = None,
             mesh=None) -> None:
        """``extra``: small JSON-able sidecar state saved with the step
        — e.g. the data loader's ``state_dict()``.  ``mesh``, the
        formation a gang supervisor hands every checkpointer, is
        ignored: this format is whole tensors.  A step that already
        has a committed generation is left as it is (module
        docstring)."""
        self._wait()
        step = int(step)
        if (self.directory / str(step)).is_dir():
            return
        payload = {
            _PARAMS: _serialized({name: _to_cpu(t)
                                  for name, t in named_tensors(params)}),
            _OPT: _serialized(_to_cpu(opt_state.state_dict())),
            _EXTRA: json.dumps(extra or {}, sort_keys=True).encode(),
        }
        self._pending = self._writer.submit(self._commit, step, payload)
        if wait:
            self._wait()

    def _wait(self) -> None:
        """Wait for the write in flight; raises what it raised."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def _commit(self, step: int, payload: dict[str, bytes]) -> None:
        tmp = Path(tempfile.mkdtemp(prefix=f".tmp-{step}-",
                                    dir=self.directory))
        try:
            for name, data in payload.items():
                atomicio.write_durable_bytes(tmp / name, data)
            atomicio.fsync_dir(tmp)
            # the write is in flight: a crash here leaves only the
            # temp directory, which is no step
            faults.crashpoint(faults.CRASH_TRAIN_CKPT_SAVING)
            os.rename(tmp, self.directory / str(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        atomicio.fsync_dir(self.directory)
        faults.crashpoint(faults.CRASH_TRAIN_CKPT_COMMITTED)
        self._write_integrity(step)
        self._retain()

    def _write_integrity(self, step: int) -> None:
        """crc32-per-file sidecar for a committed generation; a crash
        between commit and sidecar leaves a generation that verifies
        trivially, never one that fails falsely."""
        step_dir = self.directory / str(step)
        files = {p.name: [_crc32_file(p), p.stat().st_size]
                 for p in sorted(step_dir.iterdir()) if p.is_file()}
        self._integrity.mkdir(parents=True, exist_ok=True)
        atomicio.write_atomic(
            self._integrity / f"{step}.json",
            json.dumps({"format": INTEGRITY_FORMAT, "step": step,
                        "files": files}, sort_keys=True))

    def _retain(self) -> None:
        """Drop generations (and sidecars) beyond the newest ``keep``."""
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / str(s), ignore_errors=True)
        retained = {str(s) for s in steps[-self.keep:]}
        if self._integrity.exists():
            for f in self._integrity.glob("*.json"):
                if f.stem not in retained:
                    f.unlink(missing_ok=True)

    # -- discovery ------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Committed steps, oldest first (temp directories of writes
        that never committed are not steps)."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> int | None:
        self._wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- restore --------------------------------------------------------

    def _verify_step(self, step: int) -> None:
        """Raise ``ShardCorruption`` when the generation's bytes no
        longer match its sidecar; pass for a generation without one."""
        step_dir = self.directory / str(step)
        if not step_dir.is_dir():
            raise FileNotFoundError(f"no checkpoint step {step} under "
                                    f"{self.directory}")
        sidecar = self._integrity / f"{step}.json"
        if not sidecar.exists():
            return
        try:
            recorded = json.loads(sidecar.read_text())["files"]
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise ShardCorruption(
                f"garbled integrity sidecar for step {step}: {e}") from e
        for rel, (crc, size) in recorded.items():
            p = step_dir / rel
            if not p.exists():
                raise ShardCorruption(f"step {step}: missing file {rel}")
            if p.stat().st_size != size:
                raise ShardCorruption(
                    f"step {step}: {rel} truncated "
                    f"({p.stat().st_size} != {size} bytes)")
            if _crc32_file(p) != crc:
                raise ShardCorruption(
                    f"step {step}: {rel} checksum mismatch")

    def _load(self, step: int, params_like, opt_state_like):
        """Verify and parse one generation and check it fits the
        targets, before anything is written into them."""
        self._verify_step(step)
        step_dir = self.directory / str(step)
        params = torch.load(step_dir / _PARAMS, map_location="cpu",
                            weights_only=True)
        opt = torch.load(step_dir / _OPT, map_location="cpu",
                         weights_only=True)
        want = named_tensors(params_like)
        if sorted(params) != sorted(name for name, _ in want):
            raise ValueError(f"step {step}: parameter names differ from "
                             f"the target's")
        for name, t in want:
            if tuple(params[name].shape) != tuple(t.shape):
                raise ValueError(
                    f"step {step}: {name} has shape "
                    f"{tuple(params[name].shape)}, the target "
                    f"{tuple(t.shape)}")
        groups = opt_state_like.state_dict()["param_groups"]
        if [len(g["params"]) for g in opt["param_groups"]] != \
                [len(g["params"]) for g in groups]:
            raise ValueError(f"step {step}: optimizer parameter groups "
                             f"differ from the target's")
        return params, opt

    def restore(self, params_like: Any, opt_state_like: Any,
                step: int | None = None) -> tuple[Any, Any, int]:
        """Restore into the targets, in place: every parameter is copied
        into its tensor in ``params_like`` (keeping that tensor's device
        and dtype) and the optimizer state is loaded into
        ``opt_state_like``, which casts it to its parameters' device and
        dtype.  ``step=None`` picks the newest readable generation,
        falling back newest-first past torn or corrupt ones; an explicit
        ``step`` raises instead.  Returns (params, opt_state, step) —
        the step actually restored."""
        self._wait()
        explicit = step is not None
        candidates = [int(step)] if explicit else self.all_steps()[::-1]
        if not candidates:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        torn: list[str] = []
        for s in candidates:
            try:
                params, opt = self._load(s, params_like, opt_state_like)
            except Exception as e:
                # any unreadable generation: torn write, flipped bits,
                # truncated or foreign files
                if explicit:
                    raise
                torn.append(f"step {s}: {type(e).__name__}: {e}")
                continue
            if torn:
                log.warning("checkpoint generation(s) unreadable, fell "
                            "back to step %d: %s", s,
                            "; ".join(t[:200] for t in torn))
            with torch.no_grad():
                for name, t in named_tensors(params_like):
                    t.copy_(params[name])
            opt_state_like.load_state_dict(opt)
            return params_like, opt_state_like, s
        raise FileNotFoundError(
            f"no restorable checkpoint under {self.directory}: "
            f"{'; '.join(torn)}")

    def restore_extra(self, step: int | None = None) -> dict:
        """The JSON sidecar saved with ``extra=``: an empty dict only
        when the generation has none; an unreadable one raises (a
        silently restarted loader would re-train consumed batches)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = self.directory / str(step) / _EXTRA
        if not path.exists():
            return {}
        return json.loads(path.read_text()) or {}

    def close(self) -> None:
        try:
            self._wait()
        finally:
            self._writer.shutdown(wait=True)


__all__ = ["INTEGRITY_FORMAT", "ShardCorruption", "TrainCheckpointer"]
