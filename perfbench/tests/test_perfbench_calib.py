"""The calibration cell and the clean-detection cell at a tiny size on the
CPU: a sound run is ``correct``, the faults of the timed path are caught,
and the spans and counters that the ``calib.*`` metrics read are kept by
the program."""
import numpy as np
import pytest

import multicam_calibration_tpu_torch as program
from multicam_calibration_tpu_torch.models import initialize
from multicam_calibration_tpu_torch.utils.metrics import metrics
from perfbench.harness import core, spec
from perfbench.tests.test_perfbench_faults import unchanged

# The card's float32 recipe, which the CPU applies only when asked: with it
# ``bundle_adjust`` runs its float64 polish there too.
RECIPE = dict(block_dtype="float32", cost_dtype="float32", solve_dtype="float32",
              grad_dtype="float32", gtol_rel=1e-6, lambda_escalation=3.0)
# The stage cut to a size a CPU test runs in seconds: the same generator,
# board, noise and dropout, fewer cameras and frames.
TINY_CALIB = {"config": {"n_cameras": 5, "n_frames": 100,
                         "calibrate": {"reanchor": True, "n_samples_for_intrinsics": 30}}}
TINY_CLEAN = {"config": {"n_cameras": 2, "frames_per_camera": 8},
              "mix": {"batch": 8, "board_per_batch": 8, "trajectory_frames": 300}}
REAL_BA = program.bundle_adjust


def moved_camera(uvs, ext, intr, objp, poses, **kw):
    """The refined rig with camera 1 moved by a millimetre where it is returned."""
    e, i, p, f, info = REAL_BA(uvs, ext, intr, objp, poses, **kw)
    e = np.array(e)
    e[1, 3] += 1.0
    return e, i, p, f, info


CASES = [None, unchanged, moved_camera]


def card_route(monkeypatch):
    """The overrides and patches that put the tiny stage on the card's route
    on the CPU: the camera-batched ``calibrate`` and the float32 recipe with
    its float64 polish in ``bundle_adjust``. (Without the polish the CPU
    route's solve may stop, at ``ftol`` 1e-4, 5e-5 above the optimum.)"""
    monkeypatch.setattr(initialize, "_batched_route",
                        lambda uvs_arr, device: uvs_arr is not None and uvs_arr.ndim == 4)
    options = spec.load_cell("stage64.calib").config["bundle_adjust"]
    return {"config": {**TINY_CALIB["config"],
                       "bundle_adjust": {**options, "lm_options": RECIPE}}}


@pytest.mark.parametrize("fault", CASES, ids=[f.__name__ if f else "sound" for f in CASES])
def test_calib_fault_is_caught(fault, monkeypatch):
    overrides = card_route(monkeypatch)
    if fault is not None:
        monkeypatch.setattr(program, "bundle_adjust", fault)
    r = core.run_cell("stage64.calib", 2**31 + 21, 0.1, 0, "cpu", overrides=overrides)
    assert r["correct"] is (fault is None), r["checks"]
    assert set(r["checks"]) == {"frames_off", "rmse_px", "cost_rel", "excess", "rot_err_rad"}
    assert list(r)[-1] == "checks"


def test_clean_detection_is_correct():
    r = core.run_cell("rig6.detect_clean", 2**31 + 21, 0.5, 0, "cpu", overrides=TINY_CLEAN)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] % 8 == 0 and r["attempted"] > 0


@pytest.fixture(scope="module")
def rig():
    return program.make_synthetic_rig(5, 60, noise_px=0.3, dropout=0.25, seed=3)


def _spans(fn):
    before = dict(metrics.stage_times)
    fn()
    return {k: v - before.get(k, 0) for k, v in metrics.stage_times.items()}


def test_calibrate_keeps_the_metrics_spans_and_counters(rig):
    got = _spans(lambda: program.calibrate(rig.all_calib_uvs, rig.img_sizes,
                                           rig.calib_objpoints, verbose=False,
                                           n_samples_for_intrinsics=20, device="cpu"))
    for span in ("calibrate.intrinsics", "calibrate.intrinsics.zhang",
                 "calibrate.intrinsics.refine", "calibrate.poses", "calibrate.extrinsics",
                 "calibrate.extrinsics.tree", "calibrate.extrinsics.chain",
                 "calibrate.consensus", "calibrate.repair"):
        assert got.get(span, 0) > 0, span
    # One solve a camera on the CPU route, each at least one iteration.
    assert got["calibrate.intrinsics.lm_iters"] >= rig.n_cameras
    assert "calibrate.repair.cameras" in got


def test_batched_intrinsics_keep_their_spans(rig):
    def lockstep():
        initialize.get_intrinsics_batch(rig.all_calib_uvs, rig.calib_objpoints,
                                        rig.img_sizes, n_samples=20, device="cpu")

    got = _spans(lockstep)
    assert got.get("calibrate.intrinsics.zhang", 0) > 0
    assert got.get("calibrate.intrinsics.refine", 0) > 0
    # At most two lockstep refines (the basin guard's second), each counting
    # its slowest camera's iterations, of at most 60.
    assert 1 <= got["calibrate.intrinsics.lm_iters"] <= 2 * 60
