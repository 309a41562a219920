"""Durable exactly-once outcome journal for the multi-process gateway.

The port of ``k8s_dra_driver_tpu/gateway/outcome_store.py``, whole:
the same line framing and checksum, the same segment names and the
same crashpoints, so a segment written by either package replays
identically in the other.

When gateway pumps are real OS processes (gateway/procpump.py), the
in-memory ``outcomes`` dict stops being a truth the fleet can trust: a
pump can die AFTER finishing a request but BEFORE the conductor hears
about it, and a naive conductor would re-run the work — a duplicate
terminal the single-process exactly-once guard (frontend.py
``_terminal``) can no longer see.  This store is the cross-process
truth: every pump appends each terminal outcome to its OWN append-only
journal segment before reporting it over the wire, with the fsync
discipline —

    write line -> flush -> [crashpoint outcome.appended] -> fsync
    -> [crashpoint outcome.committed]

— so recovery after a pump death is a pure replay: the conductor scans
the dead pump's segment and ADOPTS any terminal it never heard (no
lost terminal, no re-execution), and anything absent from the journal
is requeued and re-run, whose eventual terminal the replay view then
de-duplicates first-wins (no double terminal).  Crash windows are
armed through the process fault plan (cluster/faults.py).

Journal format, chosen for torn-append tolerance: one outcome per
line, ``crc32(payload) + " " + payload`` with a canonical JSON
payload.  A line that fails the checksum or does not parse is
DISCARDED at replay — a torn tail (the on-disk aftermath of dying
mid-append) shortens the journal by exactly the uncommitted record,
which the re-run path makes whole.  Segments are per-writer, so
concurrent pump processes never interleave bytes in one file and no
cross-process file lock exists anywhere.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from pathlib import Path

from ..cluster.faults import (CRASH_OUTCOME_APPENDED,
                              CRASH_OUTCOME_COMMITTED, crashpoint)
from ..utils.atomicio import fsync_dir

_SUFFIX = ".jsonl"


def _encode_line(entry: dict) -> str:
    payload = json.dumps(entry, sort_keys=True, separators=(",", ":"))
    crc = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
    return f"{crc:08x} {payload}\n"


def _decode_line(line: str) -> dict | None:
    """The payload, or None for anything torn/garbled (bad checksum,
    bad JSON, missing frame) — the discard-don't-crash replay rule."""
    if len(line) < 10 or line[8] != " ":
        return None
    try:
        crc = int(line[:8], 16)
    except ValueError:
        return None
    payload = line[9:].rstrip("\n")
    if zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF != crc:
        return None
    try:
        entry = json.loads(payload)
    except ValueError:
        return None
    if not isinstance(entry, dict) or "uid" not in entry \
            or "status" not in entry:
        return None
    return entry


class OutcomeView:
    """One replay of the whole store: the first-terminal-wins map plus
    the bookkeeping that proves (or disproves) the exactly-once story.

    - ``terminals``: uid -> entry, FIRST record wins in (segment name,
      line order) — deterministic regardless of which process re-runs
      a recovered request.
    - ``duplicates``: records discarded because their uid already had
      a terminal with the SAME status and tokens (the benign re-run
      after a pre-report death).
    - ``conflicts``: uids whose later records DISAGREE with the kept
      terminal — the invariant breach the chaos suite hunts for.
    - ``torn``: undecodable records at a segment's tail (a died-mid-
      append artifact, expected under crash tests).
    - ``corrupt``: undecodable records NOT at a tail — real damage,
      never produced by the append discipline itself.
    """

    def __init__(self):
        self.terminals: dict[str, dict] = {}
        self.duplicates = 0
        self.conflicts: list[str] = []
        self.torn = 0
        self.corrupt = 0

    def _fold(self, entry: dict) -> None:
        uid = entry["uid"]
        kept = self.terminals.get(uid)
        if kept is None:
            self.terminals[uid] = entry
        elif (kept["status"] == entry["status"]
              and kept.get("tokens") == entry.get("tokens")):
            self.duplicates += 1
        else:
            self.conflicts.append(uid)

    def counts(self) -> dict:
        by_status: dict[str, int] = {}
        for e in self.terminals.values():
            by_status[e["status"]] = by_status.get(e["status"], 0) + 1
        return by_status


class OutcomeWriter:
    """One process's append handle on its own journal segment.

    ``record``/``record_many`` are idempotent against everything this
    writer has already committed (including its own pre-crash records,
    replayed at open): a recovered pump re-reporting an old terminal
    writes nothing and returns False.
    """

    def __init__(self, path: Path, fsync: bool = True):
        self.path = path
        self._fsync = fsync
        #: uids this segment already holds (duplicate suppression)
        self.seen: set = set()
        existed = path.exists()
        if existed:
            raw = path.read_bytes()
            if raw and not raw.endswith(b"\n"):
                # the prior writer died mid-append leaving a torn
                # (never-committed) tail; drop it, or the next record
                # appended here would be concatenated onto the torn
                # bytes and a durably fsynced terminal would fail the
                # checksum at replay
                cut = raw.rfind(b"\n") + 1
                with open(path, "rb+") as f:
                    f.truncate(cut)
                    os.fsync(f.fileno())
                raw = raw[:cut]
            for line in raw.decode("utf-8", "replace").splitlines():
                entry = _decode_line(line + "\n")
                if entry is not None:
                    self.seen.add(entry["uid"])
        self._f = open(path, "a", encoding="utf-8")
        if not existed:
            # the NAME must survive a crash too, not just the bytes
            fsync_dir(path.parent)
        #: per-commit fsync wall times (ms) — the probe's
        #: ``outcome_fsync_ms`` durability-cost scalar reads these
        self.fsync_ms: list[float] = []
        self.records_total = 0

    def record(self, entry: dict) -> bool:
        """Append ONE terminal outcome durably; False if this writer
        already holds a terminal for the uid (nothing written)."""
        return self.record_many([entry]) == 1

    def record_many(self, entries: list[dict]) -> int:
        """Append a batch under ONE fsync (a pump commits a whole step
        round at once — per-record fsync would serialize the control
        plane on the disk).  Returns how many records were new."""
        fresh = []
        for e in entries:
            if e["uid"] in self.seen:
                continue
            fresh.append(e)
            self.seen.add(e["uid"])
        if not fresh:
            return 0
        for e in fresh:
            self._f.write(_encode_line(e))
        self._f.flush()
        # the window: bytes handed to the OS, commit not yet forced.
        # A process death here leaves the lines in the page cache
        # (they survive the PROCESS dying; only a machine crash can
        # still tear them — which the checksum framing absorbs).
        crashpoint(CRASH_OUTCOME_APPENDED)
        if self._fsync:
            t0 = time.perf_counter()
            os.fsync(self._f.fileno())
            self.fsync_ms.append((time.perf_counter() - t0) * 1000.0)
        crashpoint(CRASH_OUTCOME_COMMITTED)
        self.records_total += len(fresh)
        return len(fresh)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class OutcomeStore:
    """A directory of per-writer journal segments with a merged,
    first-terminal-wins replay view."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def writer(self, name: str, fsync: bool = True) -> OutcomeWriter:
        if "/" in name or name.startswith("."):
            raise ValueError(f"bad segment name {name!r}")
        return OutcomeWriter(self.root / f"{name}{_SUFFIX}",
                             fsync=fsync)

    def segments(self) -> list[Path]:
        return sorted(self.root.glob(f"*{_SUFFIX}"))

    def replay(self, segment: str | None = None) -> OutcomeView:
        """Scan every segment (or just ``segment``) in sorted-name
        then line order into one :class:`OutcomeView`.  Never raises
        on damaged records — discard-and-count is the whole point."""
        view = OutcomeView()
        paths = (self.segments() if segment is None
                 else [self.root / f"{segment}{_SUFFIX}"])
        for path in paths:
            if not path.exists():
                continue
            lines = path.read_text().splitlines()
            for i, line in enumerate(lines):
                entry = _decode_line(line + "\n")
                if entry is None:
                    if i == len(lines) - 1:
                        view.torn += 1
                    else:
                        view.corrupt += 1
                    continue
                view._fold(entry)
        return view


__all__ = ["OutcomeStore", "OutcomeView", "OutcomeWriter"]
