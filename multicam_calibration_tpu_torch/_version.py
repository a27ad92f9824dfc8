"""Git-derived package version (a compact versioneer analogue).

Counterpart of ``multicam_calibration_tpu/_version.py``: `git describe`
from a source checkout (a clone or a git worktree, whose ``.git`` is a
file), the distribution metadata when installed, then the fallback.
Computed once at import.
"""
import os
import re
import subprocess

_FALLBACK = "0.1.0"


def _from_git(root):
    try:
        out = subprocess.run(
            ["git", "describe", "--tags", "--dirty", "--always", "--long"],
            cwd=root, capture_output=True, text=True, timeout=5,
        )
        if out.returncode != 0:
            return None
        desc = out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return None
    if not desc:
        return None
    # v1.2.3-4-gabcdef[-dirty] -> 1.2.3.post4+gabcdef[.dirty] (PEP 440)
    m = re.match(r"v?(\d[\w.]*)-(\d+)-g([0-9a-f]+)(-dirty)?$", desc)
    if m:
        tag, n, sha, dirty = m.groups()
        local = f"+g{sha}" + (".dirty" if dirty else "")
        return tag if n == "0" and not dirty else f"{tag}.post{n}{local}"
    # No tag yet: bare (possibly -dirty) commit hash.
    m = re.match(r"([0-9a-f]+)(-dirty)?$", desc)
    if m:
        sha, dirty = m.groups()
        return f"{_FALLBACK}+g{sha}" + (".dirty" if dirty else "")
    return None


def _from_metadata():
    # Installed sdist/wheel: the version baked at build time lives in the
    # distribution metadata.
    try:
        from importlib.metadata import version, PackageNotFoundError
    except ImportError:  # pragma: no cover - py<3.8
        return None
    try:
        return version("multicam-calibration-tpu")
    except PackageNotFoundError:
        return None


def get_version():
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(pkg_dir)
    if os.path.exists(os.path.join(root, ".git")):
        v = _from_git(root)
        if v:
            return v
    v = _from_metadata()
    if v:
        return v
    return _FALLBACK


__version__ = get_version()
