"""Robust multi-view triangulation, batched over camera pairs and points.

Counterpart of ``multicam_calibration_tpu/ops/triangulation.py``: the
reference's robust median over the DLT points of every camera pair, with
observation masks instead of NaN gathers, then an optional all-view
Gauss-Newton polish with per-point standard errors.

``triangulate``'s path factors nothing: the pair DLT is the closed-form
cofactor solve of 3x3 normal equations (``_sym3_solve``), so it runs as
elementwise work on any device and never calls ``torch.linalg.eigh``, which
checks its result on the host on CUDA. Only ``triangulate_dlt`` (the
homogeneous DLT, kept for API parity) takes an eigendecomposition. The pair
median is :func:`..ops.reductions.masked_median` (one sort).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, with_highest_precision
from .projection import (
    denormalize_points,
    distort_normalized,
    distortion_valid_r2,
    normalize_points,
    undistort_normalized,
)
from .reductions import masked_median
from .transforms import get_transformation_matrix

__all__ = ["triangulate_dlt", "triangulate_pairs", "triangulate"]


def triangulate_dlt(uvs, Ps):
    """DLT triangulation of one point from V >= 2 views.

    ``uvs``: (..., V, 2) pixel coords; ``Ps``: (..., V, 3, 4) projection
    matrices. Builds the 2V x 4 design (u*P3 - P1, v*P3 - P2) and returns
    the Euclidean point minimizing ||A X|| (the smallest eigenvector of
    A^T A), batched.
    """
    u = uvs[..., 0:1]
    v = uvs[..., 1:2]
    rows_u = u * Ps[..., 2, :] - Ps[..., 0, :]
    rows_v = v * Ps[..., 2, :] - Ps[..., 1, :]
    A = torch.cat([rows_u, rows_v], dim=-2)
    ATA = torch.einsum("...ni,...nj->...ij", A, A)
    _, vecs = torch.linalg.eigh(ATA)
    X = vecs[..., :, 0]
    return X[..., :3] / X[..., 3:]


def triangulate_pairs(uvs, Ps, mask=None):
    """Triangulate every point from every camera pair.

    ``uvs``: (n_cameras, n_points, 2) undistorted pixel coords;
    ``Ps``: (n_cameras, 3, 4); ``mask``: (n_cameras, n_points) validity
    (default: finite uvs). Returns ``(points (n_pairs, n_points, 3),
    pair_valid (n_pairs, n_points))`` in the pair order (0,1),(0,2),...,(1,2).
    """
    n_cameras = uvs.shape[0]
    if mask is None:
        mask = torch.isfinite(uvs).all(-1)
    ii, jj = (torch.as_tensor(a, device=uvs.device) for a in np.triu_indices(n_cameras, k=1))
    uvs_f = torch.nan_to_num(uvs)
    pair_uvs = torch.stack([uvs_f[ii], uvs_f[jj]], dim=-2)  # (P, N, 2, 2)
    pair_Ps = torch.stack([Ps[ii], Ps[jj]], dim=-3)[:, None]  # (P, 1, 2, 3, 4)
    pts = triangulate_dlt(pair_uvs, pair_Ps)
    return pts, mask[ii] & mask[jj]


def _sym3_solve(N3, g, eps=1e-12):
    """x = N^{-1} g and diag(N^{-1}) for symmetric 3x3 batches.

    Closed-form cofactor inverse, elementwise; the tiny ridge keeps det > 0
    for all-masked points whose output is discarded.
    """
    a11 = N3[..., 0, 0] + eps
    a12, a13 = N3[..., 0, 1], N3[..., 0, 2]
    a22 = N3[..., 1, 1] + eps
    a23 = N3[..., 1, 2]
    a33 = N3[..., 2, 2] + eps
    c11 = a22 * a33 - a23 * a23
    c12 = a13 * a23 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    c22 = a11 * a33 - a13 * a13
    c23 = a12 * a13 - a11 * a23
    c33 = a11 * a22 - a12 * a12
    det = a11 * c11 + a12 * c12 + a13 * c13
    g0, g1, g2 = g[..., 0], g[..., 1], g[..., 2]
    x = torch.stack(
        [
            c11 * g0 + c12 * g1 + c13 * g2,
            c12 * g0 + c22 * g1 + c23 * g2,
            c13 * g0 + c23 * g1 + c33 * g2,
        ],
        dim=-1,
    ) / det[..., None]
    inv_diag = torch.stack([c11, c22, c33], dim=-1) / det[..., None]
    return x, inv_diag


@with_highest_precision
def _triangulate_impl(uvs, Ks, dists, exts, r2_maxs, refine=False):
    """The whole robust-triangulation pipeline on (C, N, 2) pixel coords.

    Works in normalized camera coordinates, where every matrix entry is
    O(1), so the 3x3 normal-equation solve of each pair matches the
    homogeneous DLT to well below detection noise for finite points.
    """
    mask = torch.isfinite(uvs).all(-1)  # (C, N)
    xy_n = normalize_points(uvs, Ks[:, None])
    und_n = torch.vmap(undistort_normalized)(xy_n, dists)
    # Invalid-branch guard: the radial model is invertible only inside its
    # monotonic radius, and a corrupted observation beyond it undistorts to
    # an exact round trip on the wrong branch, which entering many camera
    # pairs can poison the pair median. Drop views whose undistorted radius
    # exceeds the camera's valid radius, and views whose round trip misses
    # by more than 1 px.
    r2 = torch.sum(und_n * und_n, dim=-1)
    roundtrip = denormalize_points(torch.vmap(distort_normalized)(und_n, dists), Ks[:, None])
    rt_err = torch.linalg.vector_norm(torch.nan_to_num(roundtrip - uvs), dim=-1)
    mask = mask & (r2 < r2_maxs[:, None]) & (rt_err < 1.0)

    Rts = get_transformation_matrix(exts)[..., :3, :]  # (C, 3, 4)
    xy = torch.nan_to_num(und_n)
    # DLT rows per camera: x * P_3 - P_1, y * P_3 - P_2 -> (C, N, 2, 4).
    rows = xy[..., :, None] * Rts[:, None, None, 2, :] - Rts[:, None, :2, :]
    # Inhomogeneous least squares min ||M X + a||: the normal equations add
    # over a pair's rows, so they are built once per camera and summed per
    # pair.
    Mc = rows[..., :3]  # (C, N, 2, 3)
    ac = rows[..., 3]  # (C, N, 2)
    Nc = torch.einsum("cnri,cnrj->cnij", Mc, Mc)
    gc = torch.einsum("cnri,cnr->cni", Mc, ac)
    n_cameras = uvs.shape[0]
    ii, jj = (torch.as_tensor(a, device=uvs.device) for a in np.triu_indices(n_cameras, k=1))
    pair_valid = mask[ii] & mask[jj]
    pts, _ = _sym3_solve(Nc[ii] + Nc[jj], -(gc[ii] + gc[jj]))
    med = masked_median(pts, pair_valid[..., None], axis=0)
    if not refine:
        return med

    # Robust-gated all-view Gauss-Newton polish: starting at the median,
    # refit each point to every view whose reprojection lies within ~3 px
    # (outlier views the median rejected stay rejected), minimizing pixel
    # reprojection error; also the per-point standard error from the GN
    # covariance.
    R = Rts[..., :3]  # (C, 3, 3)
    t = Rts[..., 3]  # (C, 3)
    fx = Ks[:, 0, 0]
    gate = 3.0 / fx  # ~3 px in normalized units, per camera
    X = torch.nan_to_num(med)
    w_px = fx[:, None] ** 2

    def gn_state(X):
        Xc = torch.einsum("cij,nj->cni", R, X) + t[:, None]
        front = Xc[..., 2] > 1e-9
        z = torch.clamp(Xc[..., 2], min=1e-9)
        uv_pred = Xc[..., :2] / z[..., None]
        r = xy - uv_pred  # (C, N, 2) normalized units
        ok = mask & front & (torch.linalg.vector_norm(r, dim=-1) < gate[:, None])
        w = ok.to(X.dtype) * w_px
        Ju = (R[:, None, 0, :] - uv_pred[..., 0:1] * R[:, None, 2, :]) / z[..., None]
        Jv = (R[:, None, 1, :] - uv_pred[..., 1:2] * R[:, None, 2, :]) / z[..., None]
        J = torch.stack([Ju, Jv], dim=-2)  # (C, N, 2, 3)
        N3 = torch.einsum("cn,cnri,cnrj->nij", w, J, J)
        gg = torch.einsum("cn,cnri,cnr->ni", w, J, r)
        return N3, gg, w, r, ok

    for _ in range(3):
        N3, gg, w, r, ok = gn_state(X)
        dX, _ = _sym3_solve(N3, gg)
        X = X + dX

    N3, gg, w, r, ok = gn_state(X)
    n_ok = torch.sum(ok, dim=0)  # views per point
    valid = torch.any(pair_valid, dim=0) & (n_ok >= 2)
    out = torch.where(valid[:, None], X, med)
    # Per-point sd: sigma^2 (px^2) from the residuals, covariance from the
    # pixel-weighted normal matrix; dof = 2 * n_views - 3 (>= 1).
    wss = torch.sum(w[..., None] * r**2, dim=(0, 2))
    dof = torch.clamp(2.0 * n_ok - 3.0, min=1.0)
    _, inv_diag = _sym3_solve(N3, gg)
    sd = torch.sqrt(torch.clamp(inv_diag * (wss / dof)[:, None], min=0.0))
    sd = torch.where(valid[:, None], sd, torch.nan)
    return out, sd


def triangulate(all_uvs, all_extrinsics, all_intrinsics, refine=True,
                return_sd=False, device=None):
    """Robust triangulation: pair-median DLT + robust-gated GN polish.

    ``all_uvs`` is a list/array of (n_points, 2) per camera with NaN for
    missing observations, ``all_extrinsics`` a list/array of 6-vectors,
    ``all_intrinsics`` a list of (camera_matrix, dist_coefs). Returns an
    (n_points, 3) tensor with NaN where fewer than two cameras observed the
    point. ``refine=False`` gives the reference's median over pairs;
    ``return_sd=True`` (implies ``refine``) also returns (n_points, 3)
    per-point standard errors.

    Runs on ``device``: None means the device of a tensor ``all_uvs``,
    else the CUDA device (raising without one); pass ``device="cpu"`` for
    the CPU. numpy input is taken as f64.
    """
    refine = refine or return_sd
    out = _triangulate_impl(
        *_prep_triangulate_inputs(all_uvs, all_extrinsics, all_intrinsics, device),
        refine=refine,
    )
    if not refine:
        return out
    pts, sd = out
    return (pts, sd) if return_sd else pts


def _prep_triangulate_inputs(all_uvs, all_extrinsics, all_intrinsics, device=None):
    """Stack the list inputs into tensors on the device.

    Returns ``(uvs (C, ..., 2), Ks (C, 3, 3), dists (C, 5), exts (C, 6),
    r2_maxs (C,))``. The distortion's valid radius needs concrete
    coefficients: it is computed on the host from the caller's intrinsics
    and passed in as data.
    """
    if device is None:
        first = all_uvs if isinstance(all_uvs, torch.Tensor) else all_uvs[0]
        dev = first.device if isinstance(first, torch.Tensor) else resolve_device(None)
    else:
        dev = torch.device(device)
    uvs = torch.stack([
        u.to(dev) if isinstance(u, torch.Tensor)
        else torch.as_tensor(np.asarray(u, np.float64), device=dev)
        for u in all_uvs
    ])

    def stack(xs):
        return torch.stack([
            x.to(dtype=uvs.dtype, device=dev) if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.asarray(x), dtype=uvs.dtype, device=dev)
            for x in xs
        ])

    dists_np = np.zeros((uvs.shape[0], 5))
    for i, (_, d) in enumerate(all_intrinsics):
        d = np.asarray(d.cpu() if isinstance(d, torch.Tensor) else d, float).reshape(-1)[:5]
        dists_np[i, : d.shape[0]] = d
    r2_maxs = np.array([distortion_valid_r2(d) for d in dists_np])
    return (uvs, stack([k for k, _ in all_intrinsics]), stack(dists_np),
            stack(all_extrinsics), stack(r2_maxs))
