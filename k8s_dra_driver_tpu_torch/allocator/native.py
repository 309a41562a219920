"""Native allocator engine: ctypes wrapper over the port's
``native/tpualloc.cc``.

The port's copy of ``k8s_dra_driver_tpu/allocator/native.py``: the DFS
search core (the JAX package's, copied under the port's ``native/``)
compiled to ``build/native/libtpualloc.so`` by ``utils/nativebuild.py``
(``TPU_ALLOC_LIB`` names a prebuilt one).  Eligibility (CEL, node
filtering, candidate ordering) stays in Python; this module interns
shared tokens and constraint-attribute values to small ints, serializes
the prepared problem in the shim's text protocol, and maps the picked
candidate ids back.  ``tests/test_torch_native_alloc.py`` holds it to
pick-parity with the pure-Python engine on randomized pools.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from ..utils import nativebuild

DEFAULT_LIB = nativebuild.BUILD_DIR / "libtpualloc.so"


class NativeAllocUnavailableError(RuntimeError):
    pass


def ensure_built(source: Path | None = None,
                 lib_path: Path | None = None) -> Path:
    return nativebuild.ensure_built(
        source or (nativebuild.NATIVE_DIR / "tpualloc.cc"),
        lib_path or DEFAULT_LIB,
        "TPU_ALLOC_LIB", NativeAllocUnavailableError)


_lib = None
_load_error: NativeAllocUnavailableError | None = None


def load() -> ctypes.CDLL:
    """Build+load once; unavailability is cached too, so a host
    without a working toolchain pays the failed build attempt once,
    not per allocation (engine="auto" sits on the hot path)."""
    global _lib, _load_error
    if _load_error is not None:
        raise _load_error
    if _lib is None:
        try:
            path = ensure_built()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeAllocUnavailableError(
                    f"cannot load {path}: {e}") from e
            lib.tpu_allocate.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_int]
            lib.tpu_allocate.restype = ctypes.c_int
            lib.tpu_alloc_version.restype = ctypes.c_char_p
        except NativeAllocUnavailableError as e:
            _load_error = e
            raise
        _lib = lib
    return _lib


def _encode_problem(per_request, constraints, budget: int
                    ) -> tuple[str, dict[int, object]]:
    """Serialize the prepared problem; returns (text, id->candidate).

    ``per_request``: the allocator's [(req, eligible, match_attrs)]
    with eligible already in Python search order (order IS the
    contract — the shim must pick what the Python DFS would).
    """
    from ..api.resource import ALLOCATION_MODE_ALL

    cons = [c for c in constraints if c.match_attribute]
    token_ids: dict[tuple[str, str], int] = {}
    value_ids: list[dict[object, int]] = [dict() for _ in cons]
    by_id: dict[int, object] = {}
    lines = [f"budget {budget}", "ntokens 0",
             f"nconstraints {len(cons)}"]
    next_id = 0
    for req, eligible, _ in per_request:
        mode = ("all" if req.allocation_mode == ALLOCATION_MODE_ALL
                else "exact")
        lines.append(f"request {req.name} count {req.count} mode {mode}")
        for c in eligible:
            toks = []
            for tok in sorted(c.tokens):
                toks.append(token_ids.setdefault(tok, len(token_ids)))
            cvals = []
            for ci, con in enumerate(cons):
                if con.requests and req.name not in con.requests:
                    cvals.append(-2)
                    continue
                v = c.device.attributes.get(con.match_attribute)
                if v is None:
                    cvals.append(-1)
                    continue
                cvals.append(value_ids[ci].setdefault(
                    v, len(value_ids[ci])))
            by_id[next_id] = c
            toks_s = ",".join(map(str, sorted(toks))) if toks else "-"
            vals_s = ",".join(map(str, cvals)) if cvals else "-"
            lines.append(f"cand {next_id} tokens {toks_s} cvals {vals_s}")
            next_id += 1
    lines[1] = f"ntokens {len(token_ids)}"
    return "\n".join(lines), by_id


def solve(per_request, constraints, budget: int
          ) -> tuple[str, dict[str, list] | None]:
    """Run the native search. Returns (status, chosen):
    status in {"ok", "nosolution", "budget"}; chosen maps request name
    -> [candidate] on "ok".  Raises NativeAllocUnavailableError when
    the shim cannot be built/loaded (caller falls back to Python).
    """
    text, by_id = _encode_problem(per_request, constraints, budget)
    lib = load()
    encoded = text.encode()
    rc, out = 4, ""
    cap = 1 << 20
    while rc == 4 and cap <= (1 << 26):   # rc 4 = result didn't fit
        buf = ctypes.create_string_buffer(cap)
        rc = lib.tpu_allocate(encoded, buf, cap)
        out = buf.value.decode()
        cap *= 8
    if rc == 2:
        return "budget", None
    if rc == 1:
        return "nosolution", None
    if rc != 0:
        raise NativeAllocUnavailableError(f"shim error rc={rc}: {out}")
    chosen: dict[str, list] = {}
    for part in out.split()[1:]:
        name, _, ids = part.partition("=")
        chosen[name] = [by_id[int(i)] for i in ids.split(",") if i]
    return "ok", chosen


def version() -> str:
    return load().tpu_alloc_version().decode()
