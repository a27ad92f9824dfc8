"""Flatibration: align world coordinates so the XY plane is the arena floor.

Counterpart of ``multicam_calibration_tpu/models/flatibration.py``: a
vectorized RANSAC plane fit (every hypothesis solved and scored at once),
the masked least-squares refit of the best consensus set, and the Kabsch
alignment of the plane's canonical axes.

The hypotheses are drawn from a ``torch.Generator`` seeded with ``seed``,
on the host, so the CPU and the card draw the same samples; they are not
JAX's ``jax.random.randint`` draws (threefry), which the port cannot
reproduce. :func:`_ransac_plane_fit_from_samples` takes the samples as
data, so a caller holding JAX's indices gets JAX's fit exactly.

Entry points take numpy (or tensors) and run on ``device``: None means the
device of a tensor argument, else the CUDA device (raising without one);
pass ``device="cpu"`` for the CPU. They return numpy, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import with_highest_precision
from ..ops.homography import inv3x3
from ..ops.transforms import (
    apply_rigid_transform,
    get_transformation_matrix,
    get_transformation_vector,
    rigid_transform_from_correspondences,
)
from .initialize import _pick, _t

__all__ = [
    "get_floor_points",
    "ransac_plane_fit",
    "flatibrate",
    "flip_z_axis",
    "center_arena",
]


def get_floor_points(keypoints, z_points_down=False):
    """Lowest (or highest, if z points down) keypoint per frame (numpy)."""
    if isinstance(keypoints, list):
        keypoints = np.concatenate(keypoints)
    keypoints = np.asarray(keypoints)
    if z_points_down:
        ix = np.argmax(keypoints[:, :, 2], axis=1)
    else:
        ix = np.argmin(keypoints[:, :, 2], axis=1)
    return keypoints[np.arange(keypoints.shape[0]), ix]


@with_highest_precision
def _ransac_plane_fit_from_samples(points, idx, residual_threshold):
    """RANSAC over the given minimal samples: ``points`` (n, 3), ``idx``
    (H, 3) point indices. Solves each sample's z = a x + b y + t, scores
    its inliers (|residual| < threshold), takes the first hypothesis with
    the most (``torch.argmax``, as ``jnp.argmax``) and refits its consensus
    set by least squares. Returns (a, b, t, inlier_mask) as tensors.
    """
    n = points.shape[0]
    tri = points[idx]  # (H, 3, 3)
    ones = torch.ones((*tri.shape[:2], 1), dtype=points.dtype, device=points.device)
    A = torch.cat([tri[..., :2], ones], dim=-1)  # rows [x, y, 1]
    # Degenerate (collinear) samples give inf/NaN and score zero inliers.
    coef = torch.einsum("hij,hj->hi", inv3x3(A), tri[..., 2])  # (H, 3)
    pred = (points[:, 0][None] * coef[:, 0:1] + points[:, 1][None] * coef[:, 1:2]
            + coef[:, 2:3])
    resid = torch.abs(points[:, 2][None] - pred)  # (H, n)
    inliers = (resid < residual_threshold) & torch.isfinite(resid)
    best = torch.argmax(inliers.sum(1))
    mask = inliers[best]

    # Weighted LSQ refit on the consensus set.
    w = mask.to(points.dtype)
    X = torch.cat([points[:, :2], ones.new_ones(n, 1)], dim=-1)
    XtX = (X * w[:, None]).T @ X
    Xtz = (X * w[:, None]).T @ points[:, 2]
    a, b, t = inv3x3(XtX) @ Xtz
    return a, b, t, mask


def ransac_plane_fit(points, residual_threshold=10.0, n_hypotheses=256, seed=0,
                     device=None):
    """Fit z = a x + b y + t by vectorized RANSAC + inlier least-squares refit.

    ``n_hypotheses`` minimal 3-point samples are drawn with a
    ``torch.Generator`` seeded with ``seed`` (on the host), then solved and
    scored at once. Returns (a, b, t, inlier_mask) as tensors.
    """
    pts = _t(points, _pick(device, points))
    gen = torch.Generator().manual_seed(int(seed))
    idx = torch.randint(0, pts.shape[0], (n_hypotheses, 3), generator=gen)
    return _ransac_plane_fit_from_samples(pts, idx.to(pts.device), residual_threshold)


def _plane_transform(a, b, t):
    """Rigid transform taking the plane z = a x + b y + t to z = 0: Kabsch
    on the canonical 4-point correspondence (origin + the three
    plane-adapted axes)."""
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    x_axis = torch.stack([one, zero, a])
    y_axis = torch.stack([zero, one, b])
    z_axis = torch.stack([-a, -b, one])
    origin = torch.stack([zero, zero, t])
    source = torch.stack([origin, origin + x_axis, origin + y_axis, origin + z_axis])
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    norms = torch.stack([torch.linalg.vector_norm(v) for v in (x_axis, y_axis, z_axis)])
    target = torch.cat([eye.new_zeros(1, 3), eye * norms[:, None]])
    transform, _ = rigid_transform_from_correspondences(source, target)
    return transform


def flatibrate(floor_points, residual_threshold=10.0, n_hypotheses=256, seed=0,
               device=None):
    """Rigid transform (numpy 6-vector) mapping the floor plane to the XY
    plane: RANSAC plane z = ax + by + t, then the Kabsch fit of
    :func:`_plane_transform`."""
    if isinstance(floor_points, list):
        floor_points = np.concatenate(floor_points)
    a, b, t, _ = ransac_plane_fit(
        floor_points, residual_threshold=residual_threshold,
        n_hypotheses=n_hypotheses, seed=seed, device=device,
    )
    return _plane_transform(a, b, t).cpu().numpy()


def flip_z_axis(transform, device=None):
    """Compose with a 180-degree rotation about X (numpy 6-vector)."""
    T = get_transformation_matrix(_t(transform, _pick(device, transform)))
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=T.dtype, device=T.device))
    return get_transformation_vector(flip @ T).cpu().numpy()


def center_arena(transform, floor_points, center_method="midrange", range_pctl=1,
                 device=None):
    """Compose with the XY translation that centers the arena at the origin
    (midrange, mean or median of the transformed floor points; numpy
    6-vector). The transform is applied on the device, the center taken on
    the host as in JAX."""
    if isinstance(floor_points, list):
        floor_points = np.concatenate(floor_points)
    dev = _pick(device, transform, floor_points)
    T = get_transformation_matrix(_t(transform, dev))
    pts = apply_rigid_transform(T, _t(floor_points, dev)).cpu().numpy()[:, :2]
    if center_method == "midrange":
        center = np.percentile(pts, [range_pctl, 100 - range_pctl], axis=0).mean(0)
    elif center_method == "mean":
        center = np.mean(pts, axis=0)
    elif center_method == "median":
        center = np.median(pts, axis=0)
    else:
        raise ValueError("center_method should be 'midrange', 'mean', or 'median'")
    translation = _t(np.array([0, 0, 0, -center[0], -center[1], 0], dtype=float), dev)
    return get_transformation_vector(get_transformation_matrix(translation) @ T).cpu().numpy()
