"""``bundle_adjust``'s per-frame reprojection statistics, reduced on the
device, against numpy oracles of the formulas they replace.

Imports neither JAX nor the JAX package (``tests/test_torch_cuda.py``
imports the oracles on the card). The problems are built so that each
decision has room: detections are the forward model plus an offset of a
chosen length, so every point's error is that length to ~1e-13 px. The
median of an even count of errors is the mean of the two middle ones; one
frame lies strictly between 5 x the lower middle value and 5 x that mean,
so a lower-median implementation (``torch.nanmedian``) decides it the other
way. Frame sets are compared exactly.
"""
import warnings

import numpy as np
import pytest
import torch

import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu_torch.models import bundle_adjustment as tba
from multicam_calibration_tpu_torch.models import lm_core as tlm
from multicam_calibration_tpu_torch.utils.metrics import metrics

CPU = "cpu"
LOW, HIGH = 0.1, 0.3  # the two middle errors: median 0.2, threshold 1.0
BETWEEN = 0.75  # above 5 x LOW, below 5 x (LOW + HIGH) / 2


def numpy_select(uvs, ext, intr, objp, poses, n_frames=10000, outlier_threshold=None, seed=0):
    """``select_ba_frames`` as numpy computed it, on the CPU forward model."""
    uvs = np.asarray(uvs)
    full = ~np.isnan(uvs).any((-1, -2))
    use = np.nonzero(full.sum(0) > 1)[0]
    pred = tba.predict_calib_uvs(ext, intr, objp, np.asarray(poses)[use], device=CPU).numpy()
    err = np.linalg.norm(uvs[:, use] - pred, axis=-1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        worst = np.nanmax(np.nanmean(err, axis=-1), axis=0)
        if outlier_threshold is None:
            outlier_threshold = 5 * np.nanmedian(err)
    use = use[~(np.nan_to_num(worst) > outlier_threshold)]
    if n_frames is not None and n_frames < len(use):
        use = np.sort(np.random.default_rng(seed).choice(use, n_frames, replace=False))
    return use


def numpy_flag(cam, poses, obs, mask, objp, threshold=5.0):
    """The pose repair's flag as numpy computed it: (bad, per-frame error)."""
    err = np.linalg.norm(tlm.compute_residuals(cam, poses, obs, mask, objp).numpy(), axis=-1)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        per_frame = np.nanmean(np.where(mask.numpy(), err, np.nan), axis=(0, 2))
    return np.nan_to_num(per_frame, nan=0.0) > threshold * np.nanmedian(per_frame), per_frame


def _offsets(lengths, rng):
    """(..., 2) offsets of the given lengths in random directions."""
    angle = rng.uniform(0, 2 * np.pi, np.shape(lengths))
    return np.stack([np.cos(angle), np.sin(angle)], -1) * np.asarray(lengths)[..., None]


def _lows_and_highs(n_low, n_high, rng):
    """Errors at most LOW (one exactly) and at least HIGH (one exactly)."""
    low = rng.uniform(0.02, LOW, n_low)
    high = rng.uniform(HIGH, 0.45, n_high)
    low[0], high[0] = LOW, HIGH
    return np.concatenate([low, high])


def _selection_problem():
    """3 cameras x 10 frames of a 12-point board. Frame 0 is seen whole by
    every camera, camera 0 at error BETWEEN; frame 1's camera 1 errs by 3.0
    (an outlier); frame 2 is seen whole by no camera, frame 3 by camera 0
    alone (neither is selected; their errors of 50 px must not enter the
    median); frame 4's pose is NaN (selected, no error: its worst counts as
    0); frames 5-9 are filler, with four points of frame 5 undetected by
    camera 2. The remaining errors split so that the observed points of the
    selectable frames, an even count, have LOW and HIGH as middle values."""
    rng = np.random.default_rng(11)
    rig = tmct.make_synthetic_rig(3, 10, board_shape=(3, 4), noise_px=0.0, dropout=0.0, seed=4)
    ext, intr, objp, poses = (rig.all_extrinsics, rig.all_intrinsics, rig.calib_objpoints,
                              rig.calib_poses.copy())
    pred = tba.predict_calib_uvs(ext, intr, objp, poses, device=CPU).numpy()
    C, F, N, _ = pred.shape
    length = np.full((C, F, N), np.nan)
    length[0, 0], length[1, 1] = BETWEEN, 3.0  # 2 x N errors above HIGH
    length[:, 2:4] = 50.0
    length[:, 4] = LOW
    filler = np.isnan(length)
    seen = np.ones((C, F, N), bool)
    seen[:, 2, 0] = False  # no camera whole
    seen[1:, 3, 5] = False  # camera 0 alone whole
    seen[2, 5, :4] = False
    filler &= seen
    n_filler = int(filler.sum())
    n_high = (n_filler - 2 * N) // 2
    length[filler] = rng.permutation(_lows_and_highs(n_filler - n_high, n_high, rng))
    uvs = pred + _offsets(np.nan_to_num(length), rng)
    uvs[~seen] = np.nan
    poses[4] = np.nan
    return uvs, ext, intr, objp, poses


@pytest.mark.parametrize("kw", [{}, dict(n_frames=4, seed=1), dict(n_frames=4, seed=2),
                                dict(outlier_threshold=0.6)],
                         ids=["defaults", "subsample-seed1", "subsample-seed2", "threshold"])
def test_select_ba_frames_matches_numpy(kw):
    args = _selection_problem()
    want = numpy_select(*args, **kw)
    got = tba.select_ba_frames(*args, verbose=False, device=CPU, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if not kw:
        # The design: numpy's threshold keeps frame 0 where the lower middle
        # value's would drop it; frames 1-3 go, frame 4 (no error) stays.
        np.testing.assert_array_equal(got, [0, 4, 5, 6, 7, 8, 9])
        uvs, ext, intr, objp, poses = args
        use = [0, 1, 4, 5, 6, 7, 8, 9]
        pred = tba.predict_calib_uvs(ext, intr, objp, poses[use], device=CPU).numpy()
        err = np.linalg.norm(uvs[:, use] - pred, axis=-1)
        err = np.sort(err[~np.isnan(err)])
        assert len(err) % 2 == 0
        lo, hi = err[len(err) // 2 - 1], err[len(err) // 2]
        assert 5 * lo < BETWEEN - 1e-6 and BETWEEN + 1e-6 < 5 * (lo + hi) / 2
    if "outlier_threshold" in kw:
        assert 0 not in got
    if "n_frames" in kw:
        assert len(got) == kw["n_frames"]


def test_frame_errors_match_numpy():
    """Both statistics of ``_frame_errors`` on errors with unobserved
    points, a camera-frame and a whole frame with none observed."""
    rng = np.random.default_rng(2)
    err = rng.gamma(2.0, 0.2, (5, 9, 12))
    err[rng.random(err.shape) < 0.3] = np.nan
    err[2, 3] = np.nan
    err[:, 6] = np.nan
    worst, mean = (t.numpy() for t in tba._frame_errors(torch.as_tensor(err)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        want_worst = np.nan_to_num(np.nanmax(np.nanmean(err, axis=-1), axis=0))
        want_mean = np.nanmean(err, axis=(0, 2))
    np.testing.assert_allclose(worst, want_worst, rtol=1e-14, atol=0)
    np.testing.assert_allclose(mean, want_mean, rtol=1e-14, atol=0)
    assert worst[6] == 0 and np.isnan(mean[6])


def _repair_problem():
    """3 cameras x 11 frames at the true rig, the detections offset by a
    length per frame: frames 0-4 at most LOW, 5-7 at least HIGH, frame 8 at
    BETWEEN, frame 9 at HIGH with its pose moved 300 mm off (far above the
    threshold), frame 10 unobserved. 10 observed frames, an even count."""
    rng = np.random.default_rng(5)
    rig = tmct.make_synthetic_rig(3, 11, board_shape=(3, 4), noise_px=0.0, dropout=0.0, seed=8)
    f64 = dict(dtype=torch.float64)
    cam = torch.as_tensor(tba._params_to_arrays(rig.all_extrinsics, rig.all_intrinsics), **f64)
    poses = torch.as_tensor(rig.calib_poses, **f64)
    objp = torch.as_tensor(rig.calib_objpoints, **f64)
    C, F, N = cam.shape[0], poses.shape[0], objp.shape[0]
    pred = -tlm.compute_residuals(cam, poses, torch.zeros((C, F, N, 2), **f64),
                                  torch.ones((C, F, N), dtype=torch.bool), objp).numpy()
    per_frame = np.concatenate([[0.05, 0.07, 0.08, 0.09, LOW], [HIGH, 0.35, 0.4],
                                [BETWEEN, HIGH, 0.0]])
    obs = pred + _offsets(np.broadcast_to(per_frame[None, :, None], (C, F, N)), rng)
    mask = rng.random((C, F, N)) > 0.1
    mask[:, 10] = False
    poses = poses.clone()
    poses[9, 3:] += 300.0
    return cam, poses, torch.as_tensor(np.where(mask[..., None], obs, 0.0)), \
        torch.as_tensor(mask), objp


def test_repair_flags_the_frames_numpy_flags():
    cam, poses, obs, mask, objp = _repair_problem()
    bad, per_frame = numpy_flag(cam, poses, obs, mask, objp)
    np.testing.assert_array_equal(np.nonzero(bad)[0], [9])
    lo, hi = np.sort(per_frame[~np.isnan(per_frame)])[4:6]
    assert 5 * lo < per_frame[8] < 5 * (lo + hi) / 2  # a lower median flags frame 8 too
    before = metrics.stage_times.get("ba.pose_repair.flagged", 0)
    out, n_repaired = tba._repair_bad_poses(cam, poses, obs, mask, objp,
                                            tlm.LMOptions(ftol=1e-4, loss="soft_l1",
                                                          max_iters=20))
    assert metrics.stage_times["ba.pose_repair.flagged"] - before == 1
    assert n_repaired == 1
    np.testing.assert_array_equal(np.nonzero((out != poses).any(-1).numpy())[0], [9])
