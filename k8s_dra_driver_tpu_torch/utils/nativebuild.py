"""Shared build-or-load logic for the port's native shims.

The port's copy of ``k8s_dra_driver_tpu/utils/nativebuild.py``, over
the port's own sources: the C++ shims (``native/tpudiscovery.cc``,
``native/tpualloc.cc`` and the fake NVIDIA driver of the fake trees,
``native/fakenvidia.cc``) live in ``k8s_dra_driver_tpu_torch/native/``
and build with ``g++`` at first use into ``build/native/`` at the root
of the checkout (listed in ``.gitignore``).  An environment variable
naming a prebuilt library wins; a library newer than its source is
reused.  The compiler writes a name of its own process, then
``os.replace`` puts the library in place, so test workers building at
once never load a half-written file.  A failed build raises
``error_cls``.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"


def ensure_built(source: Path, lib_path: Path, env_var: str | None,
                 error_cls: type[Exception]) -> Path:
    """Return a usable shared library, compiling it if needed."""
    explicit = os.environ.get(env_var) if env_var else None
    if explicit:
        return Path(explicit)
    if lib_path.exists() and (not source.exists() or
                              lib_path.stat().st_mtime >=
                              source.stat().st_mtime):
        return lib_path
    if not source.exists():
        raise error_cls(f"shim source missing: {source}")
    tmp = lib_path.with_name(f".{lib_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-Wall", "-std=c++17", "-fPIC", "-shared",
           "-o", str(tmp), str(source), "-ldl"]
    try:
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise error_cls(f"cannot build shim: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise error_cls(f"shim build failed: {out.stderr[-2000:]}")
    os.replace(tmp, lib_path)
    return lib_path
