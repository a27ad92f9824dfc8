"""Batched planar homography ops (DLT fit, application, image warping).

Counterpart of ``multicam_calibration_tpu/ops/homography.py``: a
Hartley-normalized DLT solved through a batched 9x9 eigendecomposition or
the gauge-fixed 8x8 normal equations, point application, and a bilinear
inverse warp. Every function is batched over leading dims and follows the
device of its inputs.
"""
from __future__ import annotations

import math

import torch

from .transforms import euclidean_to_homogenous, homogeneous_to_euclidean

INVERSE_ITERS = 4  # fit_homography(method="inverse"): each step gains lambda_1 / lambda_2

__all__ = [
    "fit_homography",
    "apply_homography",
    "get_perspective_transform",
    "inv3x3",
    "warp_perspective",
]


def _normalization_transform(pts):
    """Hartley normalization: similarity mapping pts to mean 0, RMS sqrt(2)."""
    mean = pts.mean(dim=-2, keepdim=True)
    centered = pts - mean
    scale = math.sqrt(2.0) / torch.clamp(
        torch.linalg.vector_norm(centered, dim=-1).mean(dim=-1), min=1e-12
    )
    s = scale[..., None, None]
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    mx = mean[..., 0:1, 0:1]
    my = mean[..., 0:1, 1:2]
    row0 = torch.cat([s, zeros, -s * mx], dim=-1)
    row1 = torch.cat([zeros, s, -s * my], dim=-1)
    row2 = torch.cat([zeros, zeros, ones], dim=-1)
    return torch.cat([row0, row1, row2], dim=-2)


def inv3x3(M):
    """Closed-form (adjugate) 3x3 inverse, batched over leading dims.
    Singular inputs give inf/NaN, as in the JAX package."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = a * A + b * D + c * G
    adj = torch.stack(
        [
            torch.stack([A, B, C], dim=-1),
            torch.stack([D, E, F], dim=-1),
            torch.stack([G, H, I], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def fit_homography(src, dst, weights=None, method="eigh"):
    """Least-squares homography H with dst ~ H @ src, batched over leading dims.

    ``src``/``dst``: (..., N, 2) with N >= 4; ``weights`` (..., N) scales
    each correspondence's rows (weight 0 removes it). ``method``:

    - ``"eigh"``: the ||h|| = 1 DLT, smallest eigenvector of A^T A (9x9);
    - ``"solve"``: h33 = 1 and the 8x8 normal equations by Cholesky, for the
      near-affine lattice and anchor homographies of detection. A system
      that is not positive definite yields NaN rather than an error, as
      JAX's Cholesky does; callers mask such fits.
    - ``"inverse"``: the ``"eigh"`` DLT's smallest eigenvector by inverse
      iteration on A^T A shifted by a few ulps of its trace (Cholesky, then
      ``INVERSE_ITERS`` solves). ``torch.linalg.eigh`` checks its result on
      the host, which synchronises a CUDA stream; this does not, so queued
      detection work can run ahead. Where the two smallest eigenvalues are
      well apart (any fit with small residuals) it equals ``"eigh"`` to
      rounding; a failed factorization yields NaN.
    """
    Ts = _normalization_transform(src)
    Td = _normalization_transform(dst)
    src_n = homogeneous_to_euclidean(
        torch.einsum("...ij,...nj->...ni", Ts, euclidean_to_homogenous(src))
    )
    dst_n = homogeneous_to_euclidean(
        torch.einsum("...ij,...nj->...ni", Td, euclidean_to_homogenous(dst))
    )
    x, y = src_n[..., 0], src_n[..., 1]
    u, v = dst_n[..., 0], dst_n[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    row_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y, -u], dim=-1)
    row_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([row_u, row_v], dim=-2)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    if method == "solve":
        A8, a9 = A[..., :8], A[..., 8]
        N8 = torch.einsum("...ni,...nj->...ij", A8, A8)
        g8 = torch.einsum("...ni,...n->...i", A8, a9)
        eye8 = torch.eye(8, dtype=A.dtype, device=A.device)
        tr = N8.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
        L, info = torch.linalg.cholesky_ex(N8 + 1e-9 * tr * eye8)
        L = torch.where((info == 0)[..., None, None], L, torch.nan)
        h8 = torch.cholesky_solve(-g8[..., None], L)[..., 0]
        h = torch.cat([h8, torch.ones_like(h8[..., :1])], dim=-1)
    elif method == "eigh":
        ATA = torch.einsum("...ni,...nj->...ij", A, A)
        _, vecs = torch.linalg.eigh(ATA)
        h = vecs[..., :, 0]
    elif method == "inverse":
        ATA = torch.einsum("...ni,...nj->...ij", A, A)
        tr = ATA.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
        shift = 4 * torch.finfo(A.dtype).eps * tr
        L, info = torch.linalg.cholesky_ex(ATA + shift * torch.eye(9, dtype=A.dtype, device=A.device))
        L = torch.where((info == 0)[..., None, None], L, torch.nan)
        x = torch.ones(ATA.shape[:-1] + (1,), dtype=A.dtype, device=A.device)
        for _ in range(INVERSE_ITERS):
            x = torch.cholesky_solve(x, L)
            x = x / torch.linalg.vector_norm(x, dim=-2, keepdim=True)
        h = x[..., 0]
    else:
        raise ValueError(f"unknown method {method!r}")
    Hn = h.reshape(*h.shape[:-1], 3, 3)
    H = torch.linalg.solve_triangular(Td, Hn @ Ts, upper=True)
    return H / H[..., 2:3, 2:3]


def apply_homography(H, pts):
    """Apply 3x3 homographies to points (..., N, 2)."""
    out = torch.einsum("...ij,...nj->...ni", H, euclidean_to_homogenous(pts))
    return homogeneous_to_euclidean(out)


def get_perspective_transform(src, dst):
    """Exact homography from 4 point pairs (cv2.getPerspectiveTransform)."""
    return fit_homography(src, dst)


def warp_perspective(image, H, out_shape):
    """Inverse-warp ``image`` (H, W) or (H, W, C) by homography ``H``.

    Samples ``image`` at ``H^-1 @ (x, y, 1)`` for each output pixel with
    bilinear interpolation and zero padding (``cv2.warpPerspective``
    semantics). ``out_shape`` is (out_h, out_w).
    """
    out_h, out_w = out_shape
    Hinv = inv3x3(H)
    kw = dict(dtype=Hinv.dtype, device=Hinv.device)
    ys, xs = torch.meshgrid(
        torch.arange(out_h, **kw), torch.arange(out_w, **kw), indexing="ij"
    )
    grid = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
    src_xy = apply_homography(Hinv, grid).reshape(out_h, out_w, 2)
    x, y = src_xy[..., 0], src_xy[..., 1]

    img = image if image.ndim == 3 else image[..., None]
    in_h, in_w = img.shape[:2]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < in_h) & (xi >= 0) & (xi < in_w)
        yi_c = yi.clamp(0, in_h - 1).to(torch.int64)
        xi_c = xi.clamp(0, in_w - 1).to(torch.int64)
        vals = img[yi_c, xi_c].to(wx.dtype)
        return torch.where(valid[..., None], vals, 0.0)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    out = (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )
    return out[..., 0] if image.ndim == 2 else out
