"""Token-dataset loading: memory-mapped corpora -> batches.

The port's own copy of ``k8s_dra_driver_tpu/models/data.py``, the
input pipeline of the training step:

- Corpora are ``np.memmap`` views of flat binary token files (uint16
  for vocab <= 65536, else uint32, no header): the OS page cache
  streams them and the loader never materializes the corpus.
- Every batch is exactly ``[batch, seq_len]`` int32; ``loss_fn``
  shifts inside the window and the short tail window is dropped.
- Batch order is a pure function of ``(seed, epoch)`` (a per-epoch
  permutation of window starts, numpy's generator as in the JAX
  package, so both loaders yield the same batches) and the iterator
  state is two integers: pass ``state_dict()`` as the ``extra=``
  sidecar of ``TrainCheckpointer.save`` and feed ``restore_extra()``
  back into ``load_state_dict()`` so a restored run consumes exactly the
  batches the interrupted one had not.
- ``stripe_index/stripe_count`` make each process materialize only its
  contiguous row stripe of the global batch, and :func:`as_global`
  puts the stripes back together into the global batch the train step
  takes.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def write_token_file(tokens, path: Path | str, vocab: int) -> Path:
    """Persist a flat token sequence as the loader's binary format
    (dtype chosen from the vocab; the file IS the array)."""
    path = Path(path)
    dtype = np.uint16 if vocab <= 2 ** 16 else np.uint32
    arr = np.asarray(tokens)
    if arr.min() < 0 or arr.max() >= vocab:
        raise ValueError(f"tokens out of range for vocab {vocab}")
    arr.astype(dtype).tofile(path)
    return path


def load_token_file(path: Path | str, vocab: int) -> np.ndarray:
    """mmap a token file written by ``write_token_file``."""
    dtype = np.uint16 if vocab <= 2 ** 16 else np.uint32
    return np.memmap(path, dtype=dtype, mode="r")


@dataclasses.dataclass
class BatchLoader:
    """Deterministic, resumable batches over a flat token corpus.

    ``tokens``: 1-D array-like (typically ``load_token_file``'s
    memmap).  Yields ``[batch, seq_len]`` int32 numpy windows; batch
    order is a pure function of ``(seed, epoch)``.
    """

    tokens: np.ndarray
    batch: int
    seq_len: int
    seed: int = 0
    shuffle: bool = True
    # this process materializes only its contiguous batch-row stripe;
    # the order is global, so every process agrees on step s's windows
    stripe_index: int = 0
    stripe_count: int = 1
    # resume state (the whole of it)
    epoch: int = 0
    step: int = 0

    def __post_init__(self):
        if self.batch < 1 or self.seq_len < 1:
            raise ValueError(
                f"batch ({self.batch}) and seq_len ({self.seq_len}) "
                "must be >= 1")
        self.n_windows = len(self.tokens) // self.seq_len
        if self.n_windows < self.batch:
            raise ValueError(
                f"corpus has {self.n_windows} windows of {self.seq_len} "
                f"tokens; need at least batch={self.batch}")
        if not 0 <= self.stripe_index < self.stripe_count:
            raise ValueError(
                f"stripe {self.stripe_index}/{self.stripe_count}")
        if self.batch % self.stripe_count:
            raise ValueError(
                f"batch {self.batch} does not stripe over "
                f"{self.stripe_count} processes")
        self.steps_per_epoch = self.n_windows // self.batch
        self._order_cache = None

    def _epoch_order(self, epoch: int) -> np.ndarray:
        # cached: an O(n_windows) permutation per step would make the
        # host input path scale with the corpus
        if self._order_cache is not None and self._order_cache[0] == epoch:
            return self._order_cache[1]
        if not self.shuffle:
            order = np.arange(self.n_windows, dtype=np.int64)
        else:
            order = np.random.default_rng(
                (self.seed, epoch)).permutation(self.n_windows)
        self._order_cache = (epoch, order)
        return order

    def _batch_at(self, epoch: int, step: int) -> np.ndarray:
        order = self._epoch_order(epoch)
        starts = order[step * self.batch:(step + 1) * self.batch] \
            * self.seq_len
        k = self.batch // self.stripe_count
        starts = starts[self.stripe_index * k:(self.stripe_index + 1) * k]
        return np.stack([np.asarray(self.tokens[s:s + self.seq_len])
                         for s in starts]).astype(np.int32)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self.step >= self.steps_per_epoch:
            self.epoch += 1
            self.step = 0
        out = self._batch_at(self.epoch, self.step)
        self.step += 1
        return out

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.step = int(state["step"])


def local_rows(batch: np.ndarray) -> np.ndarray:
    """This process's contiguous row stripe of a global batch: rank r of
    an initialized ``torch.distributed`` group of n processes keeps
    rows ``[r*k, (r+1)*k)``; without a group the process keeps all."""
    if dist.is_available() and dist.is_initialized():
        n, p = dist.get_world_size(), dist.get_rank()
    else:
        n, p = 1, 0
    if batch.shape[0] % n:
        raise ValueError(
            f"global batch {batch.shape[0]} does not stripe over "
            f"{n} processes")
    k = batch.shape[0] // n
    return batch[p * k:(p + 1) * k]


def as_global(local_batch, mesh=None) -> torch.Tensor:
    """Local rows -> the global ``[B, T]`` batch as a tensor.

    Without a process mesh (``mesh=None``, or the gang supervisor's
    in-process gang, parallel/supervisor.py, whose dp rows all live in
    this process) the local batch is the global one.  Over a
    ``parallel.mesh.ProcessMesh`` each process holds the rows of its
    batch coordinate (its ``local_rows`` when every process is on dp)
    and they are gathered over the batch axes, in coordinate order,
    into the global batch on the mesh's device — what the port's
    ``make_train_step(..., mesh=mesh)`` takes on every rank."""
    from ..parallel.mesh import BATCH_AXES, ProcessMesh

    x = torch.as_tensor(np.asarray(local_batch))
    if not isinstance(mesh, ProcessMesh):
        return x
    x = x.to(mesh.device)
    # the batch is laid out dp-major over (dp, ep): gather the inner
    # axis first
    for axis in reversed(BATCH_AXES):
        x = mesh.all_gather(x, axis, dim=0)
    return x


__all__ = ["BatchLoader", "as_global", "load_token_file", "local_rows",
           "write_token_file"]
