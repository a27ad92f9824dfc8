"""Calibration uncertainty: standard errors from the Schur complement.

Counterpart of ``multicam_calibration_tpu/models/uncertainty.py``. At the
bundle-adjustment optimum the Gauss-Newton approximation of the parameter
covariance is

    Cov(theta) ~= sigma^2 (J^T W J)^{-1}

with W the IRLS weights of the robust loss. ``lm_core.build_normal_blocks``
gives J^T W J in blocks: U (cameras), V (poses), W (cross). Eliminating the
poses gives the reduced camera system S = U - sum_f W_f V_f^{-1} W_f^T,
whose inverse is the camera-parameter covariance marginalized over the
board poses.

Gauge: a rig's absolute pose is unobservable, so the root camera's
extrinsics are frozen (identity-padded in S, their sd exactly 0), and the
uncertainties are relative to the root camera's frame.

Route: the blocks are built with f64 ``LMOptions(loss="soft_l1",
f_scale=1.0)``. The BA kernels implement only the all-f32 recipe
(``lm_core._cuda_block_build``), so on the card this path takes the plain
torch route in f64, as the JAX package takes XLA; it launches no kernel.
The solves are SPD Cholesky inverses.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import with_highest_precision
from .bundle_adjustment import _params_to_arrays
from .initialize import _pick
from .lm_core import (
    LMOptions,
    _blockdiag_embed,
    _diag_embed,
    _robust_weights,
    _spd_inverse,
    build_normal_blocks,
    compute_residuals,
)

__all__ = ["calibration_uncertainty"]


def _free_mask(n_cameras, root, dtype, device=None):
    cam_free = np.ones((n_cameras, 12), np.float64)
    cam_free[root, 6:] = 0.0  # gauge: the root camera defines the world frame
    return torch.as_tensor(cam_free, dtype=dtype, device=device)


@with_highest_precision
def _uncertainty_impl(cam, poses, obs, mask, objpoints, cam_free):
    opts = LMOptions(loss="soft_l1", f_scale=1.0)
    blocks = build_normal_blocks(cam, poses, obs, mask, objpoints, opts, cam_free=cam_free)
    C = cam.shape[0]
    dtype = cam.dtype
    eps = 1e-12

    # Undamped pose-block inverses; identity-pad empty frames (their W is
    # zero, so they add nothing to S; their sd comes out NaN through the
    # observation count).
    diag_V = torch.diagonal(blocks.V, dim1=-2, dim2=-1)
    V_inv = _spd_inverse(blocks.V + _diag_embed(eps + (diag_V <= 0).to(dtype)))  # (F, 6, 6)

    # Reduced camera system S = U - W V^-1 W^T, identity on the frozen
    # (gauge) columns so the Cholesky stays PD; their variance is masked to
    # zero afterwards.
    WVinv = torch.einsum("cfij,fjk->cfik", blocks.W, V_inv)
    S_cross = torch.einsum("afik,bfjk->aibj", WVinv, blocks.W)
    S = _blockdiag_embed(blocks.U, C) - S_cross.reshape(12 * C, 12 * C)
    free = cam_free.reshape(-1) > 0
    S = torch.where(free[:, None] & free[None, :], S, 0.0)
    S = S + torch.diag(torch.full_like(free, eps, dtype=dtype).masked_fill(~free, 1.0))
    S_inv = _spd_inverse(S)  # (12C, 12C) camera-parameter covariance / s^2
    cam_var = torch.where(free, torch.diagonal(S_inv), 0.0).reshape(C, 12)

    # Pose covariance diagonal: V^-1 + V^-1 W^T S^-1 W V^-1 per frame.
    Sinv_blocks = S_inv.reshape(C, 12, C, 12)
    X = WVinv.permute(1, 0, 2, 3)  # (F, C, 12, 6)
    cross = torch.einsum("faio,aibj,fbjp->fop", X, Sinv_blocks, X)
    pose_var = torch.diagonal(V_inv + cross, dim1=-2, dim2=-1)  # (F, 6)

    # Noise scale: weighted residual variance at the optimum.
    r = compute_residuals(cam, poses, obs, mask, objpoints)
    r2 = torch.where(mask[..., None], r**2, 0.0)
    w = torch.where(mask[..., None], _robust_weights(r2, opts) ** 2, 0.0)
    wss = torch.sum(w * r2)
    n_res = 2 * torch.sum(mask)
    frame_obs = torch.sum(mask, dim=(0, 2))  # (F,)
    return cam_var, pose_var, wss, n_res, frame_obs


def calibration_uncertainty(
    all_calib_uvs,
    all_extrinsics,
    all_intrinsics,
    calib_objpoints,
    calib_poses,
    root=0,
    device=None,
):
    """Standard errors of every calibration parameter at the BA optimum.

    Parameters mirror :func:`bundle_adjust`'s outputs: pass the adjusted
    extrinsics/intrinsics/poses with the observations they were fit to
    (``all_calib_uvs`` restricted to the frames actually used). Runs in f64
    on ``device`` (None: the CUDA device, raising without one; "cpu" for
    the CPU).

    Returns a dict of numpy/float values:

    - ``camera_sd`` (C, 12): standard error per camera parameter in the
      layout [fx, fy, cx, cy, k1, k2, rvec(3), tvec(3)]; the root camera's
      extrinsic entries are exactly 0 (gauge).
    - ``pose_sd`` (F, 6): per-frame board-pose standard errors (NaN for
      frames with no observations).
    - ``sigma_px``: estimated per-component observation noise (px).
    - ``dof``: residual degrees of freedom used for ``sigma_px``.
    """
    dev = _pick(device, all_calib_uvs)
    if isinstance(all_calib_uvs, torch.Tensor):
        all_calib_uvs = all_calib_uvs.cpu().numpy()
    obs_np = np.asarray(all_calib_uvs, np.float64)
    as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    mask = as_t(~np.isnan(obs_np).any(-1))
    obs = as_t(np.nan_to_num(obs_np))
    cam = as_t(_params_to_arrays(all_extrinsics, all_intrinsics).astype(np.float64))
    poses = as_t(np.nan_to_num(np.asarray(calib_poses, np.float64)))
    objpoints = as_t(np.asarray(calib_objpoints, np.float64))
    cam_free = _free_mask(cam.shape[0], root, cam.dtype, dev)

    out = _uncertainty_impl(cam, poses, obs, mask, objpoints, cam_free)
    cam_var, pose_var, wss, n_res, frame_obs = (x.cpu().numpy() for x in out)

    n_free = 12 * cam.shape[0] - 6 + 6 * int((frame_obs > 0).sum())
    dof = max(float(n_res) - n_free, 1.0)
    sigma2 = float(wss) / dof
    camera_sd = np.sqrt(np.clip(cam_var, 0.0, None) * sigma2)
    pose_sd = np.sqrt(np.clip(pose_var, 0.0, None) * sigma2)
    pose_sd[frame_obs == 0] = np.nan
    return {
        "camera_sd": camera_sd,
        "pose_sd": pose_sd,
        "sigma_px": float(np.sqrt(sigma2)),
        "dof": dof,
    }
