"""SE(3) rigid-transform ops, batched over leading dims.

Counterpart of ``multicam_calibration_tpu/ops/transforms.py``, limited to
what projection, initialization and bundle adjustment use: 6-vector <-> 4x4
matrix conversion, the analytic SE(3) inverse and composition, point
application and homogeneous-coordinate helpers.
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
