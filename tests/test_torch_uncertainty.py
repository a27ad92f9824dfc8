"""calibration_uncertainty: the port against the JAX package, f64 on the CPU.

The same seeded synthetic rigs go through both packages. Tolerances: the
variances of ``_uncertainty_impl`` and the public ``camera_sd``/``pose_sd``
within 1e-8 relative of JAX's (the same f64 Schur-complement algebra,
summed in other orders), ``dof`` equal, ``sigma_px`` within 1e-10. As
tests/test_uncertainty.py: the Schur marginal equals the dense (J^T W J)^-1
of the full Jacobian (rtol 1e-5), the root camera's extrinsic sd is exactly
0, and a frame without observations has NaN pose sd.
"""
import numpy as np
import pytest
import torch

import multicam_calibration_tpu as jmct
import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu.models import uncertainty as junc
from multicam_calibration_tpu_torch.models import lm_core as tlm
from multicam_calibration_tpu_torch.models import uncertainty as tunc
from multicam_calibration_tpu_torch.models.bundle_adjustment import _params_to_arrays

RTOL = 1e-8


@pytest.fixture(scope="module")
def problem():
    """3 cameras x 24 frames with dropout; frame 5 emptied (no camera sees it)."""
    rig = tmct.make_synthetic_rig(3, 24, noise_px=0.3, dropout=0.2, seed=9)
    uvs = rig.all_calib_uvs.copy()
    uvs[:, 5] = np.nan
    return rig, uvs


def _arrays(rig, uvs):
    return (_params_to_arrays(rig.all_extrinsics, rig.all_intrinsics), rig.calib_poses,
            np.nan_to_num(uvs), ~np.isnan(uvs).any(-1), rig.calib_objpoints)


def test_impl_matches_jax(problem):
    rig, uvs = problem
    arrays = _arrays(rig, uvs)
    free = tunc._free_mask(3, 0, torch.float64)
    got = tunc._uncertainty_impl(*(torch.as_tensor(a) for a in arrays), free)
    want = junc._uncertainty_impl(*arrays, junc._free_mask(3, 0, np.float64))
    for name, g, w in zip(("cam_var", "pose_var", "wss", "n_res", "frame_obs"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("root", [0, 2])
def test_public_matches_jax_with_gauge_and_empty_frame(problem, root):
    rig, uvs = problem
    args = (uvs, rig.all_extrinsics, rig.all_intrinsics, rig.calib_objpoints, rig.calib_poses)
    got = tmct.calibration_uncertainty(*args, root=root, device="cpu")
    want = jmct.calibration_uncertainty(*args, root=root)
    np.testing.assert_allclose(got["camera_sd"], want["camera_sd"], rtol=RTOL)
    np.testing.assert_allclose(got["pose_sd"], want["pose_sd"], rtol=RTOL)
    assert got["dof"] == want["dof"]
    np.testing.assert_allclose(got["sigma_px"], want["sigma_px"], rtol=1e-10)
    assert np.all(got["camera_sd"][root, 6:] == 0.0)  # gauge: exactly zero
    others = np.delete(got["camera_sd"][:, 6:], root, axis=0)
    assert np.all(others > 0) and np.all(np.isfinite(others))
    assert np.isnan(got["pose_sd"][5]).all()  # the empty frame
    assert np.isfinite(np.delete(got["pose_sd"], 5, axis=0)).all()


def test_matches_dense_covariance():
    """tests/test_uncertainty.py's oracle on the port: the dense
    (J^T W J)^-1 of the full Jacobian (``torch.func.jacfwd``, IRLS weights
    frozen at the linearization point) equals the Schur marginal."""
    from torch.func import jacfwd

    rig = tmct.make_synthetic_rig(2, 8, noise_px=0.3, dropout=0.0, seed=5)
    cam, poses, obs, mask, obj = (torch.as_tensor(a) for a in _arrays(rig, rig.all_calib_uvs))
    C, F = cam.shape[0], poses.shape[0]
    opts = tlm.LMOptions(loss="soft_l1", f_scale=1.0)
    r0 = tlm.compute_residuals(cam, poses, obs, mask, obj)
    w0 = torch.where(mask[..., None], tlm._robust_weights(r0**2, opts), 0.0)

    def resid_vec(theta):
        camv = theta[: 12 * C].reshape(C, 12)
        posv = theta[12 * C:].reshape(F, 6)
        return (w0 * tlm.compute_residuals(camv, posv, obs, mask, obj)).reshape(-1)

    J = jacfwd(resid_vec)(torch.cat([cam.reshape(-1), poses.reshape(-1)])).numpy()
    free = np.ones(12 * C + 6 * F, bool)
    free[6:12] = False
    dense = np.zeros(12 * C + 6 * F)
    dense[free] = np.diag(np.linalg.inv(J[:, free].T @ J[:, free]))
    cam_var, pose_var, *_ = tunc._uncertainty_impl(cam, poses, obs, mask, obj,
                                                   tunc._free_mask(C, 0, torch.float64))
    np.testing.assert_allclose(cam_var.numpy(), dense[: 12 * C].reshape(C, 12), rtol=1e-5)
    np.testing.assert_allclose(pose_var.numpy(), dense[12 * C:].reshape(F, 6), rtol=1e-5)


def test_uncertainty_takes_the_plain_route(problem, monkeypatch):
    """The f64 soft-L1 options are not the kernels' recipe: even with CPU
    tensors treated as CUDA, no BA kernel wrapper is called."""
    from multicam_calibration_tpu_torch.ops import ba_cuda

    def refuse(*a, **k):
        raise AssertionError("a BA kernel wrapper was called")

    monkeypatch.setattr(tlm, "_route", lambda impl, name, ok, req, objp: impl != "torch" and ok)
    monkeypatch.setattr(ba_cuda, "ba_chunk_blocks", refuse)
    monkeypatch.setattr(ba_cuda, "ba_chunk_cost", refuse)
    rig, uvs = problem
    tmct.calibration_uncertainty(uvs, rig.all_extrinsics, rig.all_intrinsics,
                                 rig.calib_objpoints, rig.calib_poses, device="cpu")


def test_uncertainty_defaults_to_the_card(problem, monkeypatch):
    rig, uvs = problem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmct.calibration_uncertainty(uvs, rig.all_extrinsics, rig.all_intrinsics,
                                     rig.calib_objpoints, rig.calib_poses)
