"""Bundle-adjustment helpers: parameter layouts and the forward model.

Counterpart of the helpers of ``multicam_calibration_tpu/models/
bundle_adjustment.py`` (:34-158) that the Schur-LM slice needs. The public
``bundle_adjust`` wrapper is not ported yet (ROADMAP.md, Queue 1).

Parameter layout (the reference's): per camera
[fx, fy, cx, cy, k1, k2, rx, ry, rz, tx, ty, tz], then F x 6 board poses.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import cuda_device
from ..ops.projection import project_points
from ..ops.transforms import euclidean_to_homogenous, get_transformation_matrix

__all__ = [
    "embed_calib_objpoints",
    "predict_calib_uvs",
    "serialize_params",
    "deserialize_params",
]


def _as_tensor(x, like=None, device=None):
    """A tensor as given; else on ``like``'s device in its dtype, or f64 on
    ``device`` (None: the CUDA device, which raises without one)."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)
    if device is None:
        device = cuda_device()
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def embed_calib_objpoints(calib_objpoints, calib_poses, device=None):
    """Board canonical points -> world coords per frame: (F, N, 3).

    A tensor ``calib_poses`` keeps its device and dtype; numpy poses go to
    ``device`` in f64 (None: the CUDA device; pass "cpu" for the CPU).
    """
    poses = _as_tensor(calib_poses, device=device)
    objp = _as_tensor(calib_objpoints, poses)
    T = get_transformation_matrix(poses)[:, None]
    pts = euclidean_to_homogenous(objp)[None, :, :, None]
    return (T @ pts)[..., :3, 0]


def predict_calib_uvs(all_extrinsics, all_intrinsics, calib_objpoints, calib_poses,
                      device=None):
    """Forward model for every camera: (C, F, N, 2), in the dtype and on the
    device of ``calib_poses`` when it is a tensor, else f64 on ``device``
    (None: the CUDA device; pass "cpu" for the CPU)."""
    pts = embed_calib_objpoints(calib_objpoints, calib_poses, device)
    preds = [
        project_points(
            pts,
            _as_tensor(all_extrinsics[i], pts),
            _as_tensor(all_intrinsics[i][0], pts),
            _as_tensor(all_intrinsics[i][1], pts),
        )
        for i in range(len(all_extrinsics))
    ]
    return torch.stack(preds)


def serialize_params(all_extrinsics, all_intrinsics, calib_poses):
    """Flatten to the reference layout (numpy)."""
    x0 = []
    for transform, (camera_matrix, dist_coefs) in zip(all_extrinsics, all_intrinsics):
        K = np.asarray(camera_matrix)
        x0.append(
            np.concatenate(
                [
                    [K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                    np.asarray(dist_coefs).reshape(-1)[:2],
                    np.asarray(transform).reshape(-1),
                ]
            )
        )
    x0.append(np.asarray(calib_poses).reshape(-1))
    return np.concatenate(x0)


def deserialize_params(x, n_cameras):
    """Inverse of :func:`serialize_params`; dist coefs are zero-padded to 5
    (k1, k2 only are optimized)."""
    x = np.asarray(x)
    all_extrinsics, all_intrinsics = [], []
    for i in range(n_cameras):
        fx, fy, cx, cy = x[i * 12 : i * 12 + 4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        dist = np.pad(x[i * 12 + 4 : i * 12 + 6], (0, 3))
        all_extrinsics.append(x[i * 12 + 6 : i * 12 + 12])
        all_intrinsics.append((K, dist))
    calib_poses = x[n_cameras * 12 :].reshape(-1, 6)
    return np.array(all_extrinsics), all_intrinsics, calib_poses


def _params_to_arrays(all_extrinsics, all_intrinsics):
    """(C, 12) cam-param matrix in the reference layout (numpy)."""
    rows = []
    for ext, (K, dist) in zip(all_extrinsics, all_intrinsics):
        K = np.asarray(K)
        rows.append(
            np.concatenate(
                [
                    [K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                    np.asarray(dist).reshape(-1)[:2],
                    np.asarray(ext).reshape(-1),
                ]
            )
        )
    return np.stack(rows)


def _arrays_to_params(cam):
    """(C, 12) cam-param matrix (numpy or tensor) -> (extrinsics, intrinsics)."""
    if isinstance(cam, torch.Tensor):
        cam = cam.detach().cpu().numpy()
    cam = np.asarray(cam)
    all_extrinsics = cam[:, 6:12]
    all_intrinsics = []
    for row in cam:
        K = np.array([[row[0], 0, row[2]], [0, row[1], row[3]], [0, 0, 1.0]])
        all_intrinsics.append((K, np.array([row[4], row[5], 0.0, 0.0, 0.0])))
    return all_extrinsics, all_intrinsics
