"""The plain references agree with the program's CPU route at a tiny
size: the BA reference's forward model, cost and frame selection, the
rolling reference's window and cost, and the detection reference's
verdict on the program's own detections."""
import numpy as np
import torch

import multicam_calibration_tpu_torch as program
from multicam_calibration_tpu_torch.models import lm_core
from multicam_calibration_tpu_torch.models.bundle_adjustment import _params_to_arrays
from perfbench.frozen import synthetic
from perfbench.reference import ba, detect, rolling


def _rig():
    return synthetic.make_synthetic_rig(6, 60, noise_px=0.3, dropout=0.25, seed=4)


def test_forward_model_and_cost_match_the_program():
    rig = _rig()
    cam = ba.camera_params(rig.all_extrinsics, rig.all_intrinsics)
    np.testing.assert_allclose(cam, _params_to_arrays(rig.all_extrinsics, rig.all_intrinsics))
    ours = ba.predict(torch.as_tensor(cam), torch.as_tensor(rig.calib_poses),
                      torch.as_tensor(rig.calib_objpoints)).numpy()
    theirs = program.predict_calib_uvs(rig.all_extrinsics, rig.all_intrinsics,
                                       rig.calib_objpoints, rig.calib_poses, device="cpu")
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=1e-9)
    prob = ba.Problem(rig.all_calib_uvs, rig.calib_objpoints, "cpu")
    pose = torch.as_tensor(rig.calib_poses)
    obs = torch.as_tensor(np.nan_to_num(rig.all_calib_uvs))
    mask = torch.as_tensor(~np.isnan(rig.all_calib_uvs).any(-1))
    theirs = float(lm_core.compute_cost(torch.as_tensor(cam), pose, obs, mask,
                                        torch.as_tensor(rig.calib_objpoints), lm_core.LMOptions()))
    assert abs(prob.cost(torch.as_tensor(cam), pose) - theirs) <= 1e-9 * theirs


def test_selection_matches_the_program():
    rig = _rig()
    ext = rig.all_extrinsics + np.random.default_rng(0).normal(0, 2e-3, rig.all_extrinsics.shape)
    for n in (None, 30):
        ours = ba.select_frames(rig.all_calib_uvs, ext, rig.all_intrinsics, rig.calib_objpoints,
                                rig.calib_poses, n, 0, "cpu")
        theirs = program.select_ba_frames(rig.all_calib_uvs, ext, rig.all_intrinsics,
                                          rig.calib_objpoints, rig.calib_poses, n_frames=n,
                                          verbose=False, device="cpu")
        np.testing.assert_array_equal(ours, theirs)


def test_polish_reaches_the_programs_optimum():
    """From a perturbed start, the reference LM and the program's f64
    bundle_adjust end at the same cost."""
    rig = _rig()
    ext = rig.all_extrinsics + np.random.default_rng(1).normal(0, 1e-3, rig.all_extrinsics.shape)
    e, i, p, frames, info = program.bundle_adjust(
        rig.all_calib_uvs, ext, rig.all_intrinsics, rig.calib_objpoints, rig.calib_poses,
        verbose=False, device="cpu", dtype="float64", ftol=1e-12, repair_poses=False)
    prob = ba.Problem(rig.all_calib_uvs[:, frames], rig.calib_objpoints, "cpu")
    cam0 = torch.as_tensor(ba.camera_params(ext, rig.all_intrinsics))
    best = prob.polish(cam0, torch.as_tensor(rig.calib_poses[frames]), 30)
    assert abs(best - float(info["final_cost"])) <= 1e-6 * best


def test_detection_reference_accepts_the_programs_detections():
    from perfbench.harness import spec
    from perfbench.jobs import detect as job
    from perfbench.tests.tiny import tiny

    cell = spec.load_cell("rig6.detect_mixed")
    over = tiny("rig6.detect_mixed")
    cell.config.update(over["config"])
    cell.mix.update(over["mix"])
    j = job.Job(cell.config, cell.mix, 3, "cpu", seconds=1)
    found = []
    for c in range(j.frames.shape[0]):
        out = program.detect_chessboard_batch(list(j.frames[c]), board_shape=(5, 7),
                                              device="cpu")
        found += [out[i][0] if i in out else None for i in range(j.frames.shape[1])]
    numbers = detect.judge(found, j.truth.reshape(-1, 35, 2), j.board.reshape(-1), 2.0)
    g = cell.config["guarantees"]
    assert numbers["false_found"] <= g["false_found"] and numbers["missed_share"] <= 0.5
    assert numbers["corner_rms_px"] < 0.6


def test_rolling_reference_follows_the_programs_window_and_cost():
    """Updates of 3 iterations past the point where the window evicts: the
    replayed window holds the program's frames, and the reference's float64
    cost at the program's cameras, with poses of its own, lies within the
    few 1e-8 that three iterations leave of the cost each update reports
    (2.2e-8 to 1.2e-7 on this rig)."""
    rig = synthetic.make_synthetic_rig(6, 96, noise_px=0.3, dropout=0.25, seed=9)
    rc = program.RollingCalibrator(rig.all_extrinsics, rig.all_intrinsics, rig.calib_objpoints,
                                   window=24, iters_per_update=3, protect_recent=8,
                                   device="cpu")
    win = rolling.Window(6, 24, 8)
    seen = ~np.isnan(rig.all_calib_uvs).any((-1, -2))
    for lo in range(0, 96, 8):
        frames = np.arange(lo, lo + 8)
        info = rc.update(rig.all_calib_uvs[:, frames])
        assert win.admit(seen[:, frames], frames) == info["admitted"]
        assert np.array_equal(win.order, rc._order)
        use = win.solved_frames()
        prob = ba.Problem(rig.all_calib_uvs[:, use], rig.calib_objpoints, "cpu")
        ext, intr = rc.calibration()
        cam = torch.as_tensor(ba.camera_params(ext, intr))
        _, cost = rolling.solve_poses(prob, cam, torch.as_tensor(rig.calib_poses[use]))
        assert abs(info["cost"] - cost) <= 1e-6 * cost
    assert win.arrivals > 24
    assert rolling.rotation_error(ext, rig.all_extrinsics) < 0.02
