"""Geometry, homography and masked-reduction ops; the CUDA kernels' wrappers
live in ``ba_cuda``, ``corner_cuda`` and ``pose_cuda``, on the one launch
path of ``_build``. Nothing here imports ``models``."""
from .rotation import rodrigues, rodrigues_inv, so3_exp, so3_log, skew
from .transforms import (
    apply_rigid_transform,
    euclidean_to_homogenous,
    get_transformation_matrix,
    get_transformation_vector,
    get_projection_matrix,
    homogeneous_to_euclidean,
    rigid_transform_from_correspondences,
    se3_compose,
    se3_inverse,
    se3_inverse_vector,
)
from .homography import (
    apply_homography,
    fit_homography,
    get_perspective_transform,
    inv3x3,
    warp_perspective,
)
from .projection import (
    denormalize_points,
    distort_normalized,
    distort_points,
    normalize_points,
    project_points,
    undistort_normalized,
    undistort_points,
)
from .reductions import masked_mean, masked_median, nanmedian
from .triangulation import triangulate, triangulate_dlt, triangulate_pairs

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
    "get_projection_matrix",
    "homogeneous_to_euclidean",
    "rigid_transform_from_correspondences",
    "se3_compose",
    "se3_inverse",
    "se3_inverse_vector",
    "denormalize_points",
    "distort_normalized",
    "distort_points",
    "normalize_points",
    "project_points",
    "undistort_normalized",
    "undistort_points",
    "apply_homography",
    "fit_homography",
    "get_perspective_transform",
    "inv3x3",
    "warp_perspective",
    "masked_mean",
    "masked_median",
    "nanmedian",
    "triangulate",
    "triangulate_dlt",
    "triangulate_pairs",
]
