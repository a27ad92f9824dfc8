"""Frozen copy of the rolling re-calibration's mount drift: the start of
the rolling cell.

Copied at commit ab4aaad3d64c from ``chip_smoke.py`` (``stream_start``,
itself tests/test_streaming.py:25-34's drift), numpy only, so the
benchmark's inputs stay fixed when the program changes.
"""
from __future__ import annotations

import numpy as np


def stream_start(rig, seed):
    """Mount drift as tests/test_streaming.py:25-34 makes it: ~0.3 degree
    rotations and ~3 mm shifts on every camera but the first."""
    rng = np.random.default_rng(seed)
    ext = rig.all_extrinsics.copy()
    ext[:, :3] += rng.normal(0, 0.005, (len(ext), 3))
    ext[:, 3:] += rng.normal(0, 3.0, (len(ext), 3))
    ext[0] = rig.all_extrinsics[0]
    return ext, [(K.copy(), d.copy()) for K, d in rig.all_intrinsics]
