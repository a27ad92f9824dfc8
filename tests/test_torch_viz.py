"""The port's viz module vs the JAX package's.

``compute_residual_metric`` on a small synthetic rig (4 cameras x 40
frames, noise 0.3 px, dropout 0.25, so every camera has NaN frames) at
perturbed parameters: the medians, reprojections and transformed
reprojections equal JAX's to rtol 1e-9 (both f64; the homography DLT runs
through different eigensolvers and the median through different sorts,
rounding at ~1e-12 relative), with NaN exactly where JAX has it. The plots
run on matplotlib's Agg backend and return what JAX's return; the axis
helpers are plain numpy and equal JAX's exactly.
"""
import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import multicam_calibration_tpu as jmct  # noqa: E402
from multicam_calibration_tpu import viz as jviz  # noqa: E402
from multicam_calibration_tpu_torch import viz as tviz  # noqa: E402

RTOL = 1e-9


@pytest.fixture(scope="module")
def problem():
    rig = jmct.make_synthetic_rig(n_cameras=4, n_frames=40, noise_px=0.3, dropout=0.25, seed=3)
    rng = np.random.default_rng(0)
    ext = rig.all_extrinsics + rng.normal(0, 1e-3, rig.all_extrinsics.shape) * np.r_[[1.0] * 3, [5.0] * 3]
    intr = []
    for K, d in rig.all_intrinsics:
        K = K.copy()
        K[[0, 1], [0, 1]] *= 1 + rng.normal(0, 1e-3, 2)
        K[:2, 2] += rng.normal(0, 1.0, 2)
        intr.append((K, d + rng.normal(0, 1e-3, d.shape)))
    poses = rig.calib_poses + rng.normal(0, 1e-3, rig.calib_poses.shape)
    poses[5] = np.nan  # a frame without a consensus pose
    return rig.all_calib_uvs, ext, intr, rig.calib_objpoints, poses


@pytest.fixture(scope="module")
def jax_metric(problem):
    return jviz.compute_residual_metric(*problem)


def test_compute_residual_metric_matches_jax(problem, jax_metric):
    uvs = problem[0]
    assert np.isnan(uvs).any((-1, -2)).any(1).all(), "every camera needs NaN frames"
    got = tviz.compute_residual_metric(*problem, device="cpu")
    for g, r in zip(got, jax_metric):
        assert isinstance(g, np.ndarray) and g.shape == np.asarray(r).shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=0, equal_nan=True)
    assert np.all(np.isfinite(got[0])) and np.all(got[0] > 0)


def test_compute_residual_metric_takes_tensors(problem, jax_metric):
    uvs, ext, intr, objp, poses = problem
    as_t = torch.as_tensor
    med, _, _ = tviz.compute_residual_metric(
        as_t(uvs), as_t(ext), [(as_t(K), as_t(d)) for K, d in intr], as_t(objp), as_t(poses),
        device="cpu")
    np.testing.assert_allclose(med, jax_metric[0], rtol=RTOL, atol=0)


def test_plot_residuals_matches_jax(problem, jax_metric):
    import matplotlib.pyplot as plt

    fig, med, reproj, transformed = tviz.plot_residuals(*problem, device="cpu")
    assert len(fig.axes) == 6  # 2 rows x 3 columns for 4 cameras
    np.testing.assert_allclose(med, jax_metric[0], rtol=RTOL, atol=0)
    assert reproj.shape == jax_metric[1].shape and transformed.shape == jax_metric[2].shape
    plt.close(fig)


def test_host_plots_and_axis_helpers(problem, tmp_path):
    import matplotlib.pyplot as plt

    uvs = problem[0]
    assert tviz.pad_axis_limits(0, 10, -5, 5, 0.2) == jviz.pad_axis_limits(0, 10, -5, 5, 0.2)
    data = np.random.default_rng(1).normal(size=(200, 2))
    fig, (a, b) = plt.subplots(1, 2)
    tviz.set_axis_limits(a, data)
    jviz.set_axis_limits(b, data)
    assert a.get_xlim() == b.get_xlim() and a.get_ylim() == b.get_ylim()
    plt.close(fig)

    tree = [(0, 1), (1, 2), (2, 3)]
    fig, shared = tviz.plot_shared_detections(uvs, tree)
    _, ref = jviz.plot_shared_detections(uvs, tree)
    np.testing.assert_array_equal(shared, ref)
    plt.close("all")

    floor = np.random.default_rng(2).normal(size=(300, 3)) * [100, 100, 2]
    t = np.array([0.05, -0.02, 0.01, 1.0, 2.0, 3.0])
    fig = tviz.visualize_flatibration(t, floor, keypoints=floor[:50] + [0, 0, 30])
    ref = jviz.visualize_flatibration(t, floor, keypoints=floor[:50] + [0, 0, 30])
    for ax_t, ax_j in zip(fig.axes, ref.axes):
        for col_t, col_j in zip(ax_t.collections, ax_j.collections):
            np.testing.assert_allclose(col_t.get_offsets(), col_j.get_offsets(), rtol=1e-12)
    plt.close("all")
