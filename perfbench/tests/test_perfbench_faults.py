"""A whole run on the CPU at a tiny size, the chip look skipped, with the
timed path broken underneath: ``correct`` comes out false for each fault
the cell can have, and true without one. (No cell exchanges data between
chips.)"""
import numpy as np
import pytest

import multicam_calibration_tpu_torch as program
from perfbench.harness import core
from perfbench.tests.tiny import tiny

REAL_DETECT = program.detect_chessboard_batches
REAL_BA = program.bundle_adjust
REAL_ROLLING = program.RollingCalibrator


def half_the_frames(batches, **kw):
    """Detections of every other frame of a batch left out."""
    for out in REAL_DETECT(batches, **kw):
        yield {i: v for i, v in out.items() if i % 2 == 0}


def shifted_corners(batches, **kw):
    """Every detection's corners moved by one pixel where they are made."""
    for out in REAL_DETECT(batches, **kw):
        yield {i: (uv + 1.0, s) for i, (uv, s) in out.items()}


def unchanged(uvs, ext, intr, objp, poses, **kw):
    """A refinement that returns its start: the selection is made, nothing moves."""
    import torch

    from multicam_calibration_tpu_torch.models import lm_core
    from multicam_calibration_tpu_torch.models.bundle_adjustment import _params_to_arrays

    kw.pop("verbose", None)
    frames = program.select_ba_frames(uvs, ext, intr, objp, poses, verbose=False,
                                      device=kw["device"], n_frames=kw.get("n_frames", 10000))
    obs = uvs[:, frames]
    cost = lm_core.compute_cost(
        torch.as_tensor(_params_to_arrays(ext, intr)), torch.as_tensor(poses[frames]),
        torch.as_tensor(np.nan_to_num(obs)), torch.as_tensor(~np.isnan(obs).any(-1)),
        torch.as_tensor(objp), lm_core.LMOptions())
    return np.asarray(ext), intr, np.asarray(poses)[frames], frames, {"final_cost": float(cost)}


def half_the_batch(uvs, ext, intr, objp, poses, **kw):
    """The refinement solved over half of its frames."""
    n = len(program.select_ba_frames(uvs, ext, intr, objp, poses, verbose=False,
                                     device=kw["device"]))
    return REAL_BA(uvs, ext, intr, objp, poses, **{**kw, "n_frames": n // 2})


def altered(uvs, ext, intr, objp, poses, **kw):
    """The refined rig with camera 0's focal length changed where it is returned."""
    e, i, p, f, info = REAL_BA(uvs, ext, intr, objp, poses, **kw)
    K = i[0][0].copy()
    K[0, 0] *= 1.01
    return e, [(K, i[0][1])] + list(i[1:]), p, f, info


class UnchangedRolling(REAL_ROLLING):
    """Updates that admit their frames and return with the cameras they
    started from."""

    def update(self, batch_uvs):
        ext = self._ext.copy()
        info = super().update(batch_uvs)
        self._ext = ext
        return info


class HalfBatchRolling(REAL_ROLLING):
    """Updates fed every other frame of their batch."""

    def update(self, batch_uvs):
        return super().update(batch_uvs[:, ::2])


class AlteredRolling(REAL_ROLLING):
    """Camera 1 moved by a millimetre where the cameras are returned."""

    def calibration(self):
        ext, intr = super().calibration()
        ext[1, 3] += 1.0
        return ext, intr


CASES = [("rig6.detect_mixed", "detect_chessboard_batches", f)
         for f in (None, half_the_frames, shifted_corners)] + [
    ("stage64.ba", "bundle_adjust", f) for f in (None, unchanged, half_the_batch, altered)] + [
    ("stage64.rolling", "RollingCalibrator", f)
    for f in (None, UnchangedRolling, HalfBatchRolling, AlteredRolling)]


@pytest.mark.parametrize("cell,name,fault", CASES,
                         ids=[f"{c}-{f.__name__ if f else 'sound'}" for c, _, f in CASES])
def test_fault_is_caught(cell, name, fault, monkeypatch):
    if fault is not None:
        monkeypatch.setattr(program, name, fault)
    r = core.run_cell(cell, 33, 0.5, 0, "cpu", overrides=tiny(cell))
    assert r["correct"] is (fault is None), r["checks"]
    assert list(r)[-1] == "checks"
