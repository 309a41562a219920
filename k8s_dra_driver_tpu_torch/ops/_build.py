"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with
``ctypes``.  One ``nvcc -c`` per source, all started together, then
one link.  The library goes to ``build/cuda/<hash>/`` at the root of
the checkout (listed in ``.gitignore``), keyed by a hash of the
sources and flags, and is built at first use: nothing here runs at
import time, so the CPU tests import the kernel modules freely.

A missing ``nvcc``, a failed build or one past its deadline
(``BUILD_TIMEOUT_S``) raises.  There is no fallback:
the kernel wrappers call :func:`library` only for CUDA tensors.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "cuda"
_LIB_NAME = "libtpu_torch_kernels.so"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
          "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: seconds the compiles may take together, and the link alone (the
#: whole build takes well under a minute on an H100 host)
BUILD_TIMEOUT_S = 300.0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

#: seconds the last build took in this process (None: loaded from the
#: build directory, or not loaded yet)
build_seconds: float | None = None
#: path of the compiler log (``-Xptxas -v``: registers, shared memory
#: and spills per kernel) of the library in use
build_log: Path | None = None

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, seg, out, lse, B, T, H, Hkv, D, causal, window, scale,
    # dtype, stream
    "flash_fwd": [_VP] * 6 + [_I] * 7 + [_F, _I, _VP],
    # the tensor-core K1 (bfloat16 inputs), same arguments with the
    # output's dtype code in place of the inputs'
    "flash_fwd_tc": [_VP] * 6 + [_I] * 7 + [_F, _I, _VP],
    # K1's block entry: q, k, v, qseg, kseg, o, m, l, B, Tq, Tk, H, Hkv,
    # D, q_off, k_off, causal, window, scale, dtype, stream
    "flash_fwd_block": [_VP] * 8 + [_I] * 10 + [_F, _I, _VP],
    # the same on the tensor cores (bfloat16 inputs)
    "flash_fwd_block_tc": [_VP] * 8 + [_I] * 10 + [_F, _I, _VP],
    # q, k_pool, v_pool, tables, lengths, out, ws, counters, B, H, Hkv,
    # D, bs, n_pages, heads_per_block, pages_per_split, splits, scale,
    # dtype, stream
    "paged_decode": [_VP] * 8 + [_I] * 9 + [_F, _I, _VP],
    # q, k, v, do, lse, delta, qseg, kseg, dq, B, Tq, Tk, k_len, H, Hkv,
    # D, q_off, k_off, causal, window, scale, dtype, stream
    "flash_bwd_dq": [_VP] * 9 + [_I] * 11 + [_F, _I, _VP],
    # the same with dk, dv in place of dq
    "flash_bwd_dkv": [_VP] * 10 + [_I] * 11 + [_F, _I, _VP],
    # the tensor-core K3 and K4 (bfloat16 only), same arguments
    "flash_bwd_dq_tc": [_VP] * 9 + [_I] * 11 + [_F, _I, _VP],
    "flash_bwd_dkv_tc": [_VP] * 10 + [_I] * 11 + [_F, _I, _VP],
    # x, w, eb, nu, out, M, K, N, E, block_m, trans_w, dtype, stream
    "gmm": [_VP] * 5 + [_I] * 7 + [_VP],
    # the tensor-core K5 (bfloat16 only), same arguments
    "gmm_tc": [_VP] * 5 + [_I] * 7 + [_VP],
    # x, dy, group_sizes, nu, dw, M, K, N, E, block_m, dtype, stream
    "gmm_dw": [_VP] * 5 + [_I] * 6 + [_VP],
    # the tensor-core K6 (bfloat16 only), the same with dw's dtype code
    # after the inputs'
    "gmm_dw_tc": [_VP] * 5 + [_I] * 7 + [_VP],
    # x, q, scale, out, ws, G, M, K, N, x_g, x_m, o_g, o_m, splits,
    # k_chunk, ring, dtype, stream
    "int8_matmul": [_VP] * 5 + [_I] * 4 + [_LL] * 4 + [_I] * 4 + [_VP],
}

#: dtype codes shared with csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built")


def _start(cmd: list[str]) -> subprocess.Popen:
    # a session of its own, so that a kill at the deadline reaches
    # nvcc's children (cicc, ptxas), which hold the output pipe too
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _kill(proc: subprocess.Popen) -> str:
    """Kill ``proc``'s whole session; the output it wrote."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    try:
        out, _ = proc.communicate(timeout=10)
    except subprocess.TimeoutExpired:
        out = "(no output after the kill)"
    return out or ""


def _finish(jobs: list, seconds: float, log: list[str]) -> list:
    """Wait ``seconds`` in all for every ``(label, process)`` of
    ``jobs``, logging each one's output; returns ``(label, log entry)``
    of each that failed.  Past the deadline every process still running
    is killed, its output logged, and ``TimeoutError`` raised."""
    deadline = time.monotonic() + seconds
    failed = []
    for i, (label, proc) in enumerate(jobs):
        try:
            out, _ = proc.communicate(
                timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            late = [lb for lb, pr in jobs[i:] if pr.poll() is None]
            for lb, pr in jobs[i:]:
                state = ("killed at the deadline" if pr.poll() is None
                         else f"rc {pr.returncode}")
                log.append(f"== {lb} ({state})\n{_kill(pr)}")
            raise TimeoutError(f"{', '.join(late)} still running after "
                               f"{seconds:g} s") from None
        log.append(f"== {label} (rc {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append((label, log[-1]))
    return failed


def _build(out_dir: Path) -> None:
    """Compile every source in parallel, link, and move the result
    into ``out_dir`` atomically.  The compiles have BUILD_TIMEOUT_S
    together and the link as long again; past either deadline every
    compiler still running is killed, the build directory removed, and
    the build raises with its log so far."""
    nvcc = _nvcc()
    _BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=_BUILD_ROOT))
    compiles, objs, log = [], [], []
    try:
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            compiles.append((src.name, _start(
                [nvcc, *_FLAGS, "-I", str(_CSRC), "-c", str(src),
                 "-o", str(obj)])))
            objs.append(str(obj))
        failed = _finish(compiles, BUILD_TIMEOUT_S, log)
        if not failed:
            failed = _finish([("link", _start(
                [nvcc, *_FLAGS, "-shared", *objs, "-o",
                 str(tmp / _LIB_NAME)]))], BUILD_TIMEOUT_S, log)
    except TimeoutError as e:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(
            f"CUDA kernel build passed its deadline ({e}); log so far:\n"
            + "\n".join(log)[-8000:]) from None
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"CUDA kernel build failed ({', '.join(lb for lb, _ in failed)}"
            "):\n" + "\n".join(entry for _, entry in failed)[:8000])
    try:
        tmp.rename(out_dir)
    except OSError:
        # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = _BUILD_ROOT / _digest()
        if not (out_dir / _LIB_NAME).exists():
            t0 = time.perf_counter()
            _build(out_dir)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out_dir / _LIB_NAME))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tpu_torch_error_string.argtypes = [ctypes.c_int]
        lib.tpu_torch_error_string.restype = ctypes.c_char_p
        build_log = out_dir / "build.log"
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc:
        text = library().tpu_torch_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: {text}")
