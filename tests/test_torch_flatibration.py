"""Flatibration and the Kabsch fit: the port against the JAX package.

The same seeded floor points (tests/test_io_flatibration_viz.py's tilted
plane with 10% raised outliers) go through both packages on the CPU in f64.
JAX draws its RANSAC samples with threefry, which the port does not
reproduce; feeding JAX's samples to ``_ransac_plane_fit_from_samples``
gives JAX's fit exactly: the same inlier mask, the plane within 1e-10. On
this data (a clear consensus set) the port's own draw finds the same
inliers, and ``flatibrate``, ``flip_z_axis`` and ``center_arena`` agree
with JAX's within 1e-9. The Kabsch rotation is the same under any sign
convention of the SVD.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multicam_calibration_tpu as jmct
import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu.models import flatibration as jflat
from multicam_calibration_tpu_torch.models import flatibration as tflat

PLANE_ATOL, TRANSFORM_ATOL = 1e-10, 1e-9


@pytest.fixture(scope="module")
def floor():
    rng = np.random.default_rng(5)
    n = 400
    xy = rng.uniform(-300, 300, size=(n, 2))
    z = 0.1 * xy[:, 0] - 0.2 * xy[:, 1] + 30 + rng.standard_normal(n)
    pts = np.column_stack([xy, z])
    out = rng.choice(n, 40, replace=False)
    pts[out, 2] += rng.uniform(50, 200, size=40)
    return pts, out


@pytest.mark.parametrize("seed", [0, 3])
def test_ransac_from_jax_samples_matches_jax(floor, seed):
    pts, _ = floor
    idx = np.array(jax.random.randint(jax.random.PRNGKey(seed), (256, 3), 0, len(pts)))
    want = jflat.ransac_plane_fit(jnp.asarray(pts), seed=seed)
    got = tflat._ransac_plane_fit_from_samples(torch.as_tensor(pts), torch.as_tensor(idx), 10.0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(torch.stack(got[:3]).numpy(),
                               np.array([float(v) for v in want[:3]]), rtol=0, atol=PLANE_ATOL)


def test_degenerate_samples_score_nothing(floor):
    """Collinear (and repeated) samples solve to inf/NaN and score zero
    inliers in both packages; the first sample with the most inliers wins
    (ties go to the first, as jnp.argmax)."""
    pts, _ = floor
    line = pts.copy()
    line[:3, :2] = [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]  # collinear in x, y
    idx = np.array([[0, 1, 2], [5, 5, 5], [10, 11, 12], [10, 11, 12], [20, 21, 22]])
    from multicam_calibration_tpu.ops.homography import inv3x3

    tri = line[idx]
    A = np.concatenate([tri[..., :2], np.ones((*tri.shape[:2], 1))], -1)
    coef = np.einsum("hij,hj->hi", np.asarray(inv3x3(jnp.asarray(A))), tri[..., 2])
    j_resid = np.abs(line[:, 2][None] - (line[:, 0][None] * coef[:, :1]
                                          + line[:, 1][None] * coef[:, 1:2] + coef[:, 2:]))
    j_in = (j_resid < 10.0) & np.isfinite(j_resid)
    assert j_in[0].sum() == 0 and j_in[1].sum() == 0
    got = tflat._ransac_plane_fit_from_samples(torch.as_tensor(line), torch.as_tensor(idx), 10.0)
    best = int(np.argmax(j_in.sum(1)))
    np.testing.assert_array_equal(got[3].numpy(), j_in[best])


def test_own_draw_finds_jax_inliers(floor):
    pts, out = floor
    _, _, _, want = jflat.ransac_plane_fit(jnp.asarray(pts))
    _, _, _, got = tflat.ransac_plane_fit(pts, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.numpy()[out].any()


@pytest.mark.parametrize("call", ["flatibrate", "flip_z_axis", "center_mid", "center_mean",
                                  "center_median"])
def test_transforms_match_jax(floor, call):
    pts, _ = floor
    transform = jmct.flatibrate(pts)
    calls = {
        "flatibrate": lambda m, **kw: m.flatibrate(pts, **kw),
        "flip_z_axis": lambda m, **kw: m.flip_z_axis(transform, **kw),
        "center_mid": lambda m, **kw: m.center_arena(transform, pts, **kw),
        "center_mean": lambda m, **kw: m.center_arena(transform, pts, "mean", **kw),
        "center_median": lambda m, **kw: m.center_arena(transform, pts, "median", **kw),
    }
    got = calls[call](tmct, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (6,)
    np.testing.assert_allclose(got, calls[call](jmct), rtol=0, atol=TRANSFORM_ATOL)


def test_flattens_the_floor(floor):
    """tests/test_io_flatibration_viz.py's checks on the port."""
    pts, out = floor
    flat = tmct.apply_rigid_transform(torch.as_tensor(tmct.flatibrate(pts, device="cpu")),
                                      torch.as_tensor(pts)).numpy()
    inliers = np.setdiff1d(np.arange(len(pts)), out)
    assert np.abs(np.median(flat[inliers, 2])) < 1.0
    assert np.percentile(np.abs(flat[inliers, 2]), 90) < 3.0
    kp = np.random.default_rng(5).standard_normal((50, 8, 3))
    np.testing.assert_array_equal(tmct.get_floor_points(kp), jmct.get_floor_points(kp))
    np.testing.assert_array_equal(tmct.get_floor_points(kp, z_points_down=True),
                                  jmct.get_floor_points(kp, z_points_down=True))
    np.testing.assert_allclose(
        tmct.apply_rigid_transform(torch.as_tensor(tmct.flip_z_axis(np.zeros(6), device="cpu")),
                                   torch.tensor([[1.0, 2.0, 3.0]], dtype=torch.float64)).numpy(),
        [[1.0, -2.0, -3.0]], atol=1e-10)


@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch_matches_jax_under_flipped_svd_signs(weighted, monkeypatch):
    """rigid_transform_from_correspondences equals JAX's (t6 and rmsd, rtol
    1e-10); flipping the signs of paired singular vectors, as another SVD
    convention may, leaves the rotation unchanged (atol 1e-12)."""
    rng = np.random.default_rng(2)
    src = rng.standard_normal((12, 3)) * 100
    R = np.asarray(jmct.so3_exp(jnp.asarray([0.3, -0.2, 0.5])))
    dst = src @ R.T + [10.0, -5.0, 3.0] + rng.normal(0, 0.1, src.shape)
    w = rng.uniform(0.5, 2.0, 12) if weighted else None
    want = jmct.rigid_transform_from_correspondences(
        jnp.asarray(src), jnp.asarray(dst), None if w is None else jnp.asarray(w))
    args = (torch.as_tensor(src), torch.as_tensor(dst), None if w is None else torch.as_tensor(w))
    got = tmct.rigid_transform_from_correspondences(*args)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-10)
    svd = torch.linalg.svd

    def svd_flipped(M):
        U, S, Vt = svd(M)
        flip = torch.tensor([-1.0, 1.0, -1.0], dtype=M.dtype)
        return U * flip, S, Vt * flip[:, None]

    monkeypatch.setattr(torch.linalg, "svd", svd_flipped)
    flipped = tmct.rigid_transform_from_correspondences(*args)
    np.testing.assert_allclose(flipped[0].numpy(), got[0].numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("entry", ["flatibrate", "ransac_plane_fit", "flip_z_axis",
                                   "center_arena"])
def test_flatibration_defaults_to_the_card(floor, monkeypatch, entry):
    pts, _ = floor
    calls = {"flatibrate": lambda: tmct.flatibrate(pts),
             "ransac_plane_fit": lambda: tflat.ransac_plane_fit(pts),
             "flip_z_axis": lambda: tmct.flip_z_axis(np.zeros(6)),
             "center_arena": lambda: tmct.center_arena(np.zeros(6), pts)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
