"""Camera projection + lens distortion ops, batched over leading dims.

Counterpart of ``multicam_calibration_tpu/ops/projection.py``:

- ``project_points`` is the reference's forward model (pinhole + radial
  k1, k2 on normalized coordinates, plus tangential/k3 terms when given).
- ``undistort_normalized`` inverts the 5-coefficient OpenCV model by a
  fixed number of fixed-point iterations; NaN inputs stay NaN.
- ``distort_points`` / ``undistort_points`` apply the model and its inverse
  to pixel coordinates of one camera (the cv2.undistortPoints replacement
  with P = camera_matrix).

Array-like arguments (camera matrices, coefficients, extrinsics) are moved
to the dtype and device of the point tensor they act on.
"""
from __future__ import annotations

import numpy as np
import torch

from .transforms import apply_rigid_transform, get_transformation_matrix

__all__ = [
    "project_points",
    "distort_normalized",
    "distort_points",
    "undistort_normalized",
    "undistort_points",
    "normalize_points",
    "denormalize_points",
    "distortion_valid_r2",
]

# Fixed-point iterations for inverse distortion (cv2 uses 5; a few more keep
# the round trip at float eps even for strong distortion).
_UNDISTORT_ITERS = 12


def _like(x, ref):
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def _pad_dist_coefs(dist_coefs, ref):
    """Return (k1,k2,p1,p2,k3), zero-padding short coefficient vectors."""
    if dist_coefs is None:
        z = torch.zeros((), dtype=ref.dtype, device=ref.device)
        return z, z, z, z, z
    d = _like(dist_coefs, ref).reshape(-1)
    n = d.shape[0]
    if n < 5:
        d = torch.cat([d, d.new_zeros(5 - n)])
    return d[0], d[1], d[2], d[3], d[4]


def distortion_valid_r2(dist_coefs):
    """Squared normalized radius where the radial model stops being invertible.

    The distorted radius ``rd(r) = r * (1 + k1 r^2 + k2 r^4 + k3 r^6)`` is
    invertible only while it increases. Returns the smallest positive root
    of ``1 + 3 k1 u + 5 k2 u^2 + 7 k3 u^3`` in u = r^2, or +inf when the
    model is globally monotonic. Host-side numpy on concrete coefficients.
    """
    k = np.zeros(5)
    if dist_coefs is not None:
        d = np.asarray(dist_coefs, float).reshape(-1)[:5]
        k[: d.shape[0]] = d
    k1, k2, _, _, k3 = k
    coefs = [7.0 * k3, 5.0 * k2, 3.0 * k1, 1.0]
    coefs = np.trim_zeros(coefs, "f")
    if len(coefs) < 2:
        return np.inf
    roots = np.roots(coefs)
    pos = roots[(np.abs(roots.imag) < 1e-12) & (roots.real > 0)].real
    return float(pos.min()) if pos.size else np.inf


def distort_normalized(xy, dist_coefs):
    """Apply the 5-coefficient distortion model to normalized coords (...,2)."""
    k1, k2, p1, p2, k3 = _pad_dist_coefs(dist_coefs, xy)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xy_distorted, dist_coefs, n_iters=_UNDISTORT_ITERS):
    """Invert ``distort_normalized`` by fixed-point iteration (cv2-style)."""
    k1, k2, p1, p2, k3 = _pad_dist_coefs(dist_coefs, xy_distorted)
    xd, yd = xy_distorted[..., 0], xy_distorted[..., 1]
    x, y = xd, yd
    for _ in range(n_iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([x, y], dim=-1)


def normalize_points(uvs, camera_matrix):
    """Pixel coords (...,2) -> normalized camera coords via K^-1 (analytic)."""
    K = _like(camera_matrix, uvs)
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    skew = K[..., 0, 1]
    y = (uvs[..., 1] - cy) / fy
    x = (uvs[..., 0] - cx - skew * y) / fx
    return torch.stack([x, y], dim=-1)


def denormalize_points(xy, camera_matrix):
    """Normalized camera coords (...,2) -> pixel coords via K."""
    K = _like(camera_matrix, xy)
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    skew = K[..., 0, 1]
    u = fx * xy[..., 0] + skew * xy[..., 1] + cx
    v = fy * xy[..., 1] + cy
    return torch.stack([u, v], dim=-1)


def project_points(points, extrinsics, camera_matrix, dist_coefs=None):
    """Project world points (...,3) to pixel coords (...,2).

    Rigid transform into the camera frame, radial distortion on normalized
    coordinates, then K-projection after the perspective divide.
    """
    extrinsics = _like(extrinsics, points)
    T = (
        get_transformation_matrix(extrinsics)
        if extrinsics.shape[-1] == 6
        else extrinsics
    )
    points_cam = apply_rigid_transform(T, points)
    xy_norm = points_cam[..., :2] / points_cam[..., 2:]
    xy_dist = (
        distort_normalized(xy_norm, dist_coefs)
        if dist_coefs is not None
        else xy_norm
    )
    return denormalize_points(xy_dist, camera_matrix)


def distort_points(uvs, camera_matrix, dist_coefs):
    """Apply lens distortion to ideal pixel coords (inverse of undistort)."""
    return denormalize_points(
        distort_normalized(normalize_points(uvs, camera_matrix), dist_coefs),
        camera_matrix,
    )


def undistort_points(uvs, camera_matrix, dist_coefs):
    """Remove lens distortion from observed pixel coords (...,2).

    The output is in pixel coordinates of the same camera; NaN inputs
    propagate to NaN outputs (the iteration is NaN-transparent).
    """
    return denormalize_points(
        undistort_normalized(normalize_points(uvs, camera_matrix), dist_coefs),
        camera_matrix,
    )
