"""Geometry and homography ops; the CUDA kernels' wrappers live in
``ba_cuda`` and ``corner_cuda``."""
from .rotation import rodrigues, rodrigues_inv, so3_exp, so3_log, skew
from .transforms import (
    apply_rigid_transform,
    euclidean_to_homogenous,
    get_transformation_matrix,
    get_transformation_vector,
    homogeneous_to_euclidean,
)
from .homography import apply_homography, fit_homography, inv3x3, warp_perspective
from .projection import (
    denormalize_points,
    distort_normalized,
    normalize_points,
    project_points,
    undistort_normalized,
)

__all__ = [
    "rodrigues",
    "rodrigues_inv",
    "so3_exp",
    "so3_log",
    "skew",
    "apply_rigid_transform",
    "euclidean_to_homogenous",
    "get_transformation_matrix",
    "get_transformation_vector",
    "homogeneous_to_euclidean",
    "denormalize_points",
    "distort_normalized",
    "normalize_points",
    "project_points",
    "undistort_normalized",
    "apply_homography",
    "fit_homography",
    "inv3x3",
    "warp_perspective",
]
