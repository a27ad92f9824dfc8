"""The frozen copies: the generators equal the program's while the two
agree, and the bounds reproduce PERF.md's bound column."""
import numpy as np
import pytest

import multicam_calibration_tpu_torch as program
from perfbench.frozen import bounds, render, synthetic


@pytest.mark.parametrize("shape", [(6, 60, 11), (8, 40, 3)])
def test_make_synthetic_rig_equals_the_programs(shape):
    C, F, seed = shape
    a = synthetic.make_synthetic_rig(C, F, noise_px=0.3, dropout=0.25, seed=seed)
    b = program.make_synthetic_rig(C, F, noise_px=0.3, dropout=0.25, seed=seed)
    np.testing.assert_array_equal(a.all_calib_uvs, b.all_calib_uvs)
    np.testing.assert_array_equal(a.all_extrinsics, b.all_extrinsics)
    np.testing.assert_array_equal(a.calib_poses, b.calib_poses)


def test_video_rig_matches_chip_smoke():
    import chip_smoke

    kw = dict(n_cameras=6, n_frames=40, radius_mm=500.0, excursion_mm=40.0, img_size=(640, 480),
              noise_px=0.3, dropout=0.25, seed=11)
    a, _ = render.video_rig(board_shape=(5, 7), square_mm=12.5, **kw)
    b = chip_smoke.video_rig(**kw)
    np.testing.assert_allclose(a.all_extrinsics, b.all_extrinsics, rtol=0, atol=1e-9)
    np.testing.assert_allclose(a.calib_poses, b.calib_poses, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(np.isnan(a.all_calib_uvs), np.isnan(b.all_calib_uvs))


def test_so3_log_at_a_half_turn():
    R = np.diag([1.0, -1.0, -1.0])
    np.testing.assert_allclose(render.so3_log(R), [np.pi, 0, 0], atol=1e-12)


@pytest.mark.parametrize("sigma,ms,by", [(1.5, 0.1056, "bytes"), (9.0, 0.1455, "operations")])
def test_corner_bound_reproduces_perf_md(sigma, ms, by):
    got, why = bounds.corner_bound(128, 480, 640, sigma, 4, True)
    assert why == by and round(got, 4) == ms


def test_ba_bounds_reproduce_perf_md():
    """PERF.md's kernel table: the bench problem (6 x 922 x 35) 0.00193 ms
    by operations for the block kernel and 0.00100 ms by bytes for the cost
    kernel."""
    import os

    import chip_smoke

    prob = np.load(os.path.join(chip_smoke.HERE, "BASELINE_PROBLEM.npz"))
    rig = program.make_synthetic_rig(6, int(prob["n_frames"]), noise_px=0.3, dropout=0.25,
                                     seed=int(prob["seed"]))
    obs = rig.all_calib_uvs[:, prob["use_frames"]]
    n_obs = int((~np.isnan(obs).any(-1)).sum())
    b = bounds.ba_bounds(6, len(prob["use_frames"]), 35, n_obs)
    assert b["ba_blocks_kernel"][1] == "operations" and round(b["ba_blocks_kernel"][0], 5) == 0.00193
    assert b["ba_cost_kernel"][1] == "bytes" and round(b["ba_cost_kernel"][0], 5) == 0.00100
