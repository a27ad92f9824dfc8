"""ctypes binding of the native lattice growth (``csrc/lattice.cc``).

The host lattice ordering is the one combinatorial step of detection that
stays off the accelerator. ``detector._grow_lattice_numpy`` pays numpy's
per-call overhead on ~57 nearest-neighbour queries per frame; the C++ copy
runs the same algorithm. ``detector._grow_lattice`` takes it at pitch rung
0 with the default hole budget, as the JAX package does, unless the
environment sets ``MCC_NO_NATIVE_LATTICE``.

The library is built with the host C++ compiler at first use
(``ops/_build.load_host_library``; standard library only, no video
libraries). A failed build raises: there is no quiet fall back to numpy.
Native and numpy growth keep the same candidates, pitch and corner set; the
lattice's coordinate frame may differ by one of the 8 flip/transpose
symmetries (a near-tie in a neighbour-distance sort), which the anchor
decision downstream resolves.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

__all__ = ["DISABLE_ENV", "enabled", "grow_lattice", "library"]

DISABLE_ENV = "MCC_NO_NATIVE_LATTICE"


def enabled() -> bool:
    """False when the environment asks for the numpy growth."""
    return not os.environ.get(DISABLE_ENV)


def library():
    """The built library (``ops._build.BuiltLibrary``: path, build seconds,
    log); builds it on first use and raises if that fails."""
    from ..ops._build import load_host_library

    return load_host_library("lattice")


@functools.cache
def _fn():
    fn = library().lib.mccl_order_candidates
    fn.restype = ctypes.c_int
    dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
    fn.argtypes = [
        dp, dp, ctypes.c_int,  # pts (n, 2), scores (n,), n
        ctypes.c_int, ctypes.c_int, ctypes.c_double,  # rows, cols, pitch_tol
        ip, ip, dp, ip, ip,  # keep, n_keep, pitch, cells (i, j, idx), n_cells
    ]
    return fn


def grow_lattice(pts, sc, n_needed, pitch_tol):
    """Native counterpart of ``detector._grow_lattice_numpy`` at rung 0 with
    the default hole budget: ``(pts, sc, pitch, grid_or_None)``, with ``pts``
    and ``sc`` the kept candidates in descending-score order (the index
    space of ``grid``'s values)."""
    fn = _fn()
    pts_c = np.ascontiguousarray(pts, dtype=np.float64)
    sc_c = np.ascontiguousarray(sc, dtype=np.float64)
    n = len(pts_c)
    keep = np.empty(n, dtype=np.int32)
    cells = np.empty(3 * max(n, 1), dtype=np.int32)
    n_keep, n_cells, pitch = ctypes.c_int32(0), ctypes.c_int32(0), ctypes.c_double(0.0)
    as_p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))  # noqa: E731
    # rows * cols = n_needed is all the C side uses them for: pass (1, n).
    rc = fn(as_p(pts_c, ctypes.c_double), as_p(sc_c, ctypes.c_double), n, 1, int(n_needed),
            float(pitch_tol), as_p(keep, ctypes.c_int32), ctypes.byref(n_keep),
            ctypes.byref(pitch), as_p(cells, ctypes.c_int32), ctypes.byref(n_cells))
    if rc != 0:
        raise ValueError(f"mccl_order_candidates refused n={n}, n_needed={n_needed} (rc {rc})")
    kept = keep[: n_keep.value]
    if n_cells.value == 0:
        return pts_c[kept], sc_c[kept], float(pitch.value), None
    tri = cells[: 3 * n_cells.value].reshape(-1, 3)
    grid = {(int(i), int(j)): int(k) for i, j, k in tri}
    return pts_c[kept], sc_c[kept], float(pitch.value), grid
