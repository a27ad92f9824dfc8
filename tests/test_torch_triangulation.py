"""Triangulation: the port's ``triangulate`` against the JAX package's.

The same seeded numpy inputs go through both packages on the CPU in f64:
the synthetic rig's board corners seen by 6 cameras (15 pairs: the JAX
median takes its rank-selection path for <= 32 entries, the port sorts),
with 0.5 px noise, missing views, a point seen by one camera (NaN), a point
seen by none, gross outlier views and a view beyond its camera's valid
distortion radius. Tolerance: points and sd within 1e-8 relative + 1e-9
(mm) absolute of JAX's, NaN exactly where JAX has NaN. The cases of
tests/test_geometry.py's ``TestTriangulation`` are repeated on the port.
"""
import numpy as np
import pytest
import torch

import multicam_calibration_tpu as jmct
import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu_torch.ops import triangulation as ttri
from multicam_calibration_tpu_torch.ops.projection import distortion_valid_r2

RTOL, ATOL = 1e-8, 1e-9


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)


@pytest.fixture(scope="module")
def scene():
    """(views, exts, intr, truth): 6 cameras, 8 frames x 35 corners."""
    rig = tmct.make_synthetic_rig(6, 8, noise_px=0.0, dropout=0.0, seed=3)
    rng = np.random.default_rng(7)
    from multicam_calibration_tpu_torch.synthetic import _t6_to_T

    T = np.stack([_t6_to_T(p) for p in rig.calib_poses])
    truth = (np.einsum("fij,nj->fni", T[:, :3, :3], rig.calib_objpoints)
             + T[:, None, :3, 3]).reshape(-1, 3)
    uvs = rig.all_calib_uvs.reshape(6, -1, 2) + rng.normal(0, 0.5, (6, len(truth), 2))
    uvs[rng.uniform(size=uvs.shape[:2]) < 0.2] = np.nan  # missing views
    uvs[1:, 0] = np.nan  # point 0: one view -> NaN
    uvs[:, 1] = np.nan  # point 1: no view
    uvs[2, 10:20] += 80.0  # gross outliers in one camera
    # A view far beyond camera 3's valid distortion radius: the radial model
    # folds it back; the guard must drop it.
    K, d = rig.all_intrinsics[3]
    r_max = np.sqrt(distortion_valid_r2(d))
    uvs[3, 5] = K[:2, 2] + 3.0 * r_max * np.array([K[0, 0], K[1, 1]])
    return list(uvs), list(rig.all_extrinsics), rig.all_intrinsics, truth


@pytest.mark.parametrize("mode", ["median", "refine", "refine_sd"])
def test_triangulate_matches_jax(scene, mode):
    views, exts, intr, _ = scene
    kw = {"median": dict(refine=False), "refine": {}, "refine_sd": dict(return_sd=True)}[mode]
    want = jmct.triangulate(views, exts, intr, **kw)
    got = tmct.triangulate(views, exts, intr, device="cpu", **kw)
    for g, w in zip(got if mode == "refine_sd" else (got,),
                    want if mode == "refine_sd" else (want,)):
        assert g.dtype == torch.float64 and g.device.type == "cpu"
        _close(g.numpy(), w)
    pts = np.asarray(want[0] if mode == "refine_sd" else want)
    assert np.isnan(pts[0]).all() and np.isnan(pts[1]).all()


def test_masks_match_jax_internals(scene):
    """The stacked inputs, with the per-camera valid radii, are JAX's, and
    the distortion guard drops the view beyond the valid radius: dropping it
    by hand gives the same points."""
    from multicam_calibration_tpu.ops import triangulation as jtri

    views, exts, intr, _ = scene
    t_in = ttri._prep_triangulate_inputs(views, exts, intr, "cpu")
    j_in = jtri._prep_triangulate_inputs(views, exts, intr)
    for a, b in zip(t_in, j_in):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    clean = [v.copy() for v in views]
    clean[3][5] = np.nan
    np.testing.assert_array_equal(
        tmct.triangulate(views, exts, intr, device="cpu").numpy(),
        tmct.triangulate(clean, exts, intr, device="cpu").numpy(),
    )


def test_sym3_solve_and_pairs_match_jax(scene):
    from multicam_calibration_tpu.ops import triangulation as jtri

    rng = np.random.default_rng(1)
    A = rng.standard_normal((50, 5, 3))
    N3 = np.einsum("bki,bkj->bij", A, A)
    g = rng.standard_normal((50, 3))
    for a, b in zip(ttri._sym3_solve(torch.as_tensor(N3), torch.as_tensor(g)),
                    jtri._sym3_solve(N3, g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    views, exts, intr, _ = scene
    uvs = np.stack(views)[:, :40]
    Ps_t = tmct.get_projection_matrix(torch.as_tensor(np.stack(exts)),
                                      np.stack([k for k, _ in intr]))
    Ps_j = np.stack([np.asarray(jmct.get_projection_matrix(e, (k, d)))
                     for e, (k, d) in zip(exts, intr)])
    np.testing.assert_allclose(Ps_t.numpy(), Ps_j, rtol=1e-12)
    pts_t, valid_t = tmct.triangulate_pairs(torch.as_tensor(uvs), Ps_t)
    pts_j, valid_j = jmct.triangulate_pairs(uvs, Ps_j)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    ok = np.asarray(valid_j)
    # eigh's sign is divided out by X[3]; the DLT in pixels is conditioned
    # ~1e6, so rtol 1e-7.
    np.testing.assert_allclose(pts_t.numpy()[ok], np.asarray(pts_j)[ok], rtol=1e-7)


def test_recovers_points_and_rejects_outliers(scene):
    """As tests/test_geometry.py: the refined points reach the truth where
    the views are clean; the median is robust to the outlier camera."""
    views, exts, intr, truth = scene
    pts, sd = tmct.triangulate(views, exts, intr, return_sd=True, device="cpu")
    med = tmct.triangulate(views, exts, intr, refine=False, device="cpu").numpy()
    pts, sd = pts.numpy(), sd.numpy()
    ok = np.isfinite(sd).all(-1)  # refined points (>= 2 views within the gate)
    err = np.linalg.norm(pts[ok] - truth[ok], axis=-1)
    err_med = np.linalg.norm(med[ok] - truth[ok], axis=-1)
    assert np.median(err) < np.median(err_med) < 5.0
    z2 = np.sum(((pts[ok] - truth[ok]) / sd[ok]) ** 2, -1)
    assert 1.0 < np.median(z2) < 5.0
    assert np.isnan(sd[0]).all() and np.isnan(sd[1]).all()


def test_triangulate_defaults_to_the_card(scene, monkeypatch):
    """device=None means the CUDA device: numpy input raises without one;
    CPU tensors keep their device."""
    views, exts, intr, _ = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmct.triangulate(views, exts, intr)
    got = tmct.triangulate([torch.as_tensor(v) for v in views], exts, intr, refine=False)
    assert got.device.type == "cpu"
