"""Build and load the port's native code: compiler -> shared library -> ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
Hopper (``sm_90a``) with nvcc at first use (:func:`load_library`); each
``csrc/<name>.cc`` is host code, compiled with the host C++ compiler
(:func:`load_host_library`, with the link libraries it names). Both go
into
``multicam_calibration_tpu_torch/_build/`` (listed in ``.gitignore``), under
a name keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused, with the build's log beside the
library. Nothing here runs at import time: this module is imported on
machines with no CUDA toolkit, where only the kernels' plain PyTorch twins
run. A failed build raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BuiltLibrary", "HOST_FLAGS", "NVCC_FLAGS", "load_host_library", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, shared memory and spills
)
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    build_s: float  # 0.0 when an existing build was reused
    log: str  # nvcc/ptxas output of the build that made ``path``


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _host_cxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if found is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) found")
    return found


def _build(src: Path, compiler, flags, with_command: bool, libs=()) -> BuiltLibrary:
    """Compile ``src`` with ``compiler()`` into BUILD_DIR unless an identical
    build exists, and load it. ``libs`` (``-l...``) follow the source on the
    command line. ``with_command`` puts the command line at the top of the
    log."""
    key = hashlib.sha256(
        src.read_bytes() + " ".join(flags + tuple(libs)).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{key}.so"
    log_path = out.with_suffix(".log")
    build_s = 0.0
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
    else:
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler(), *flags, "-o", str(tmp), str(src), *libs]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        build_s = time.perf_counter() - t0
        log = (" ".join(cmd) + "\n" if with_command else "") + proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{Path(cmd[0]).name} failed to build {src.name}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return BuiltLibrary(ctypes.CDLL(str(out)), out, build_s, log)


@functools.cache
def load_library(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` with nvcc if needed and load it. Raises on
    failure."""
    return _build(CSRC_DIR / f"{name}.cu", _nvcc, NVCC_FLAGS, with_command=False)


@functools.cache
def load_host_library(name: str, libs: tuple = ()) -> BuiltLibrary:
    """Compile ``csrc/<name>.cc`` with the host C++ compiler if needed,
    linked against ``libs`` (e.g. ``("-lavformat",)``), and load it. Raises
    on failure. The log holds the command line and the compiler's output."""
    return _build(CSRC_DIR / f"{name}.cc", _host_cxx, HOST_FLAGS, with_command=True,
                  libs=tuple(libs))
