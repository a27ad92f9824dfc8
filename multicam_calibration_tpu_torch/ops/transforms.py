"""SE(3) rigid-transform ops, batched over leading dims.

Counterpart of ``multicam_calibration_tpu/ops/transforms.py``: 6-vector <->
4x4 matrix conversion, the analytic SE(3) inverse and composition, point
application, homogeneous-coordinate helpers, the weighted Kabsch fit and
projection matrices.
"""
from __future__ import annotations

import torch

from .rotation import so3_exp, so3_log

__all__ = [
    "get_transformation_matrix",
    "get_transformation_vector",
    "se3_inverse",
    "se3_inverse_vector",
    "se3_compose",
    "apply_rigid_transform",
    "euclidean_to_homogenous",
    "homogeneous_to_euclidean",
    "rigid_transform_from_correspondences",
    "get_projection_matrix",
]


def get_transformation_matrix(t):
    """6-vectors (...,6) [axis-angle | translation] -> 4x4 matrices (...,4,4)."""
    R = so3_exp(t[..., :3])
    top = torch.cat([R, t[..., 3:, None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=t.dtype, device=t.device
    ).expand(*t.shape[:-1], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def get_transformation_vector(T):
    """4x4 matrices (...,4,4) -> 6-vectors (...,6)."""
    return torch.cat([so3_log(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def se3_inverse(T):
    """Analytic inverse of 4x4 rigid transforms: [R|t]^-1 = [R^T | -R^T t]."""
    R_T = T[..., :3, :3].mT
    t_inv = -(R_T @ T[..., :3, 3:])
    top = torch.cat([R_T, t_inv], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=T.dtype, device=T.device
    ).expand(*T.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def se3_inverse_vector(t):
    """Inverse directly in 6-vector form."""
    return get_transformation_vector(se3_inverse(get_transformation_matrix(t)))


def se3_compose(t1, t2):
    """Compose 6-vector transforms: the result applies ``t2`` then ``t1``."""
    return get_transformation_vector(
        get_transformation_matrix(t1) @ get_transformation_matrix(t2)
    )


def euclidean_to_homogenous(x):
    """(..., d) -> (..., d+1) by appending a 1."""
    ones = torch.ones((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=-1)


def homogeneous_to_euclidean(x):
    """(..., d+1) -> (..., d) by perspective division."""
    return x[..., :-1] / x[..., -1:]


def apply_rigid_transform(transform, points):
    """Apply a 6-vector or (...,4,4) transform to points (...,3).

    Batched matrices broadcast against leading point dims.
    """
    if transform.shape[-1] == 6:
        transform = get_transformation_matrix(transform)
    R = transform[..., :3, :3]
    t = transform[..., :3, 3]
    return torch.einsum("...ij,...j->...i", R, points) + t


def rigid_transform_from_correspondences(source_points, target_points, weights=None):
    """Weighted Kabsch alignment: best-fit rigid transform source -> target.

    ``weights`` (n,) optionally weights each correspondence. Returns
    ``(t6, rmsd)``. The rotation V D U^T, with D fixing the
    reflection by the sign of det(V U^T), does not depend on the signs the
    SVD gives its singular vectors: flipping a pair (u_i, v_i) leaves each
    rank-one term v_i u_i^T, and det(V U^T), unchanged.
    """
    source = source_points.reshape(-1, 3)
    target = target_points.reshape(-1, 3)
    if weights is None:
        w = torch.ones(source.shape[0], dtype=source.dtype, device=source.device)
    else:
        w = torch.as_tensor(weights, device=source.device).reshape(-1).to(source.dtype)
    wsum = torch.sum(w)
    mu_s = torch.einsum("n,ni->i", w, source) / wsum
    mu_t = torch.einsum("n,ni->i", w, target) / wsum
    s_c = source - mu_s
    t_c = target - mu_t
    H = torch.einsum("n,ni,nj->ij", w, s_c, t_c)
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ D @ U.T
    translation = mu_t - R @ mu_s
    t6 = torch.cat([so3_log(R), translation])
    transformed = s_c @ R.T + mu_t
    rmsd = torch.sqrt(
        torch.einsum("n,n->", w, torch.sum((transformed - target) ** 2, -1)) / wsum
    )
    return t6, rmsd


def get_projection_matrix(extrinsics, intrinsics):
    """P = K [R|t] of shape (..., 3, 4) from 6-vector extrinsics (a tensor).

    ``intrinsics`` is the reference-style tuple ``(camera_matrix,
    dist_coefs)`` or just the camera matrix; it is moved to the dtype and
    device of ``extrinsics``.
    """
    if isinstance(intrinsics, (tuple, list)):
        intrinsics = intrinsics[0]
    K = torch.as_tensor(intrinsics, dtype=extrinsics.dtype, device=extrinsics.device)
    return K @ get_transformation_matrix(extrinsics)[..., :3, :]
