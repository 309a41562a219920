"""Build/version identification (the port's copy of
``k8s_dra_driver_tpu/utils/info.py``).

The analog of the reference's internal/info package (reference
internal/info/version.go:22-43, values injected via ``-ldflags -X``,
Makefile:59-61).  Python has no link-time injection, so the same three
fields come from module constants that a release process may rewrite,
with the git commit discovered at runtime as a convenience fallback.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

DRIVER_NAME = "tpu.google.com"

version = "0.1.0"
git_commit = ""        # release processes overwrite; else discovered below
build_date = ""


def _discover_commit() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=Path(__file__).parent, capture_output=True, text=True,
            timeout=5)
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def get_version_string() -> str:
    """"<version>-<commit>" like the reference's GetVersionString
    (version.go:36-43)."""
    commit = git_commit or _discover_commit()
    return f"{version}-{commit}" if commit else version
