"""Crash-safe prepared-claims checkpoint.

The port's copy of ``k8s_dra_driver_tpu/plugin/checkpoint.py``, in the
same file format (``checkpoint.json``, crc32 of the canonical payload,
the ``.prev`` generation), so a node can switch plugin between the two
packages without losing its prepared claims.  The analog of the reference's kubelet-checkpointmanager record
(reference cmd/nvidia-dra-plugin/checkpoint.go:9-53 and its wiring in
device_state.go:94-125): a JSON file with a checksum over the payload,
written after every successful prepare/unprepare and read back at the
start of each, making both idempotent across plugin restarts.

Two-generation durability: every save first rotates the current file
to ``checkpoint.json.prev``, then replaces ``checkpoint.json``
atomically.  ``load`` falls back to the previous generation when the
current one is torn (truncated, bad checksum, or missing because a
crash landed between the two renames) — a corrupt checkpoint degrades
the node to its last good prepared-claims view instead of bricking the
plugin (the kubelet checkpointmanager keeps no history; its corruption
story is "delete and forget every prepared claim").
"""

from __future__ import annotations

import json
import logging
import os
import zlib
from pathlib import Path

from ..cluster import faults
from ..devicemodel import PreparedClaim
from ..utils import atomicio

log = logging.getLogger(__name__)

CHECKPOINT_FILENAME = "checkpoint.json"


class ChecksumError(RuntimeError):
    """Checkpoint payload does not match its checksum (raised only
    when every on-disk generation is unusable)."""


def _checksum(payload: dict) -> int:
    canonical = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(canonical.encode())


class CheckpointManager:
    def __init__(self, plugin_root: str):
        self.path = Path(plugin_root) / CHECKPOINT_FILENAME
        self.prev_path = self.path.with_name(self.path.name + ".prev")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not self.path.exists() and not self.prev_path.exists():
            self.save({})

    def _read_one(self, path: Path) -> dict[str, PreparedClaim]:
        data = json.loads(path.read_text())
        payload = data.get("v1", {})
        if _checksum(payload) != data.get("checksum"):
            raise ChecksumError(f"corrupt checkpoint at {path}")
        return {uid: PreparedClaim.from_json(pc)
                for uid, pc in payload.get("preparedClaims", {}).items()}

    def load(self) -> dict[str, PreparedClaim]:
        try:
            return self._read_one(self.path)
        except (OSError, ValueError, KeyError, ChecksumError) as e:
            current_err = e
        try:
            prepared = self._read_one(self.prev_path)
        except (OSError, ValueError, KeyError, ChecksumError) as prev_err:
            raise ChecksumError(
                f"checkpoint at {self.path} is unusable ({current_err}) "
                f"and no previous generation survives ({prev_err})"
            ) from current_err
        log.warning("checkpoint at %s is unusable (%s); recovered %d "
                    "prepared claim(s) from the previous generation %s",
                    self.path, current_err, len(prepared), self.prev_path)
        return prepared

    def save(self, prepared: dict[str, PreparedClaim]) -> None:
        payload = {"preparedClaims": {uid: pc.to_json()
                                      for uid, pc in sorted(prepared.items())}}
        data = {"checksum": _checksum(payload), "v1": payload}
        tmp = self.path.with_suffix(".tmp")
        # fsync'd tmp write: without it the final rename can be
        # durably ordered before the data blocks, tearing BOTH
        # generations at once after power loss
        atomicio.write_durable(tmp, json.dumps(data, indent=1,
                                               sort_keys=True))
        faults.crashpoint(faults.CRASH_CHECKPOINT_TMP_WRITTEN)
        # rotate current -> .prev, then tmp -> current: a crash between
        # the two renames leaves no checkpoint.json, and load() falls
        # back to the .prev generation
        if self.path.exists():
            os.replace(self.path, self.prev_path)
        faults.crashpoint(faults.CRASH_CHECKPOINT_ROTATED)
        os.replace(tmp, self.path)
        atomicio.fsync_dir(self.path.parent)
        faults.crashpoint(faults.CRASH_CHECKPOINT_SAVED)
