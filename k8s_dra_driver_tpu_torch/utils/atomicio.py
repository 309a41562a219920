"""Durable small-file writes for the port's checkpointers.

The port's own copy of the parts of ``k8s_dra_driver_tpu/utils/
atomicio.py`` that ``models/checkpoint.py`` and
``plugin/checkpoint.py`` use: tmp file in the same
directory, fsync the data, ``os.replace`` over the target, fsync the
parent directory.  Without the two fsyncs a crash can leave the
renamed file without its data blocks.
"""

from __future__ import annotations

import os
from pathlib import Path


def fsync_dir(path) -> None:
    """fsync a DIRECTORY so a completed rename inside it survives
    power loss (POSIX orders the rename's metadata only when the
    parent directory itself is synced)."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_durable_bytes(path, data: bytes) -> None:
    """Write ``data`` to ``path`` and fsync it (no rename)."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def write_durable(path, text: str) -> None:
    """:func:`write_durable_bytes` for text (UTF-8; callers that need a
    crashpoint between write and commit do their own ``os.replace``)."""
    write_durable_bytes(path, text.encode())


def write_atomic_bytes(path, data: bytes) -> None:
    """Sibling tmp + fsync + ``os.replace`` + parent-directory fsync.
    After return the new content is durable; a crash at any interior
    point leaves the old content intact."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    write_durable_bytes(tmp, data)
    os.replace(tmp, path)
    fsync_dir(path.parent)


def write_atomic(path, text: str) -> None:
    """:func:`write_atomic_bytes` for text (UTF-8)."""
    write_atomic_bytes(path, text.encode())


__all__ = ["fsync_dir", "write_atomic", "write_atomic_bytes",
           "write_durable", "write_durable_bytes"]
