"""Chessboard detection in PyTorch, with a hand-written CUDA corner kernel.

Counterpart of ``multicam_calibration_tpu/detection/detector.py``, with the
same names, options and stages:

- **Device, batched over frames**: grayscale, the fused corner response +
  NMS (``ops.corner_cuda.corner_response_peaks``: the CUDA kernel for CUDA
  tensors, its plain twin for CPU tensors), the hierarchical tile top-K,
  device lattice ordering, cornerSubPix-style subpixel refinement and the
  anchor-orientation scores.
- **Host (numpy, tens of points)**: the lattice growth and window gates that
  order candidates of the frames the device ordering did not certify — a
  copy of the JAX package's numpy code, with the growth itself in C++
  (``native_lattice``, built with the host compiler) where the JAX package
  takes its native route.

Entry points: ``detect_chessboard_batch`` (the batch pipeline; with
``coarse_downscale = f > 1`` the low-band path: stage 1 on host-decimated
frames, full-resolution refinement on uploaded patches, escalation of lost
frames), ``detect_chessboard_batches`` (the same over an iterable of
batches, with one batch of lookahead on CUDA streams) and
``detect_chessboard`` (one frame; ``scale_factor != 1`` detects on a
resized gray and refines at full resolution).

Numerics follow the JAX package in f32. Where JAX relied on an order the
TPU gave it, the port asks for it: top-K is a stable descending sort (the
lower index wins a tie, as ``lax.top_k``), every argsort is stable, and
every stage runs with TF32 off (``device.with_highest_precision``). The
one-hot "selection matmuls" the TPU used to cut windows out of patches are
plain gathers here (exact, as the matmuls were). Shapes are not padded to
powers of two: the JAX package did that to reuse TPU compiles, and every
frame's decision is independent of the others in the batch.

Entry points take ``device=None``, meaning the CUDA device
(``device.cuda_device``, which raises when there is none); pass
``device="cpu"`` to run everything on the CPU. Results come back as numpy:
``{frame_index: (uvs (N, 2), sorted scores (4,))}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import cuda_device, with_highest_precision
from ..ops.corner_cuda import (
    corner_response_fused,
    corner_response_fused_reference,
    corner_response_peaks,
    corner_response_peaks_reference,
)
from ..ops.homography import apply_homography, fit_homography, inv3x3
from ..utils.metrics import metrics
from . import native_lattice

__all__ = [
    "corner_response",
    "find_corner_candidates",
    "refine_corners_subpix",
    "order_grid_points",
    "extend_grid",
    "reorder_chessboard_corners",
    "detect_chessboard",
    "detect_chessboard_batch",
    "detect_chessboard_batches",
]

_INF = float("inf")


def _f2i(x):
    """Float tensor -> int64, truncating toward zero. NaN maps to 0 and
    out-of-range values saturate (XLA's conversion), so garbage positions
    of rejected frames still give in-range indices after the callers'
    clamps."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0**30, neginf=-(2.0**30))
    return x.clamp(-(2.0**30), 2.0**30).to(torch.int64)


def _resolve_device(device):
    return cuda_device() if device is None else torch.device(device)


# ---------------------------------------------------------------------------
# Device stage 1: corner response + candidate extraction
# ---------------------------------------------------------------------------


def _gaussian_kernel1d(sigma, radius, dtype, device=None):
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _conv2d_separable(img, k1d):
    """Separable 2-D convolution over (B, H, W), SAME padding (vertical
    pass first, as the JAX package)."""
    r = (k1d.shape[0] - 1) // 2
    x = F.conv2d(img[:, None], k1d.view(1, 1, -1, 1), padding=(r, 0))
    x = F.conv2d(x, k1d.view(1, 1, 1, -1), padding=(0, r))
    return x[:, 0]


def _conv2d(img, kernel):
    """2-D convolution over (B, H, W) with one odd (kh, kw) kernel, SAME."""
    kh, kw = kernel.shape
    return F.conv2d(img[:, None], kernel[None, None], padding=(kh // 2, kw // 2))[:, 0]


@with_highest_precision
def corner_response(gray, sigma=1.5, impl="kernel"):
    """Saddle-point response: Ixy^2 - Ixx*Iyy (positive at X-corners).

    ``gray``: (B, H, W) float in [0, 1]. ``impl="kernel"`` runs the fused
    CUDA kernel (``ops.corner_cuda.corner_response_fused``; its plain twin
    for CPU tensors), with the Pallas kernel's border semantics;
    ``impl="conv"`` is the SAME-convolution path of the JAX package's
    ``use_pallas=False``, kept as the oracle. The two differ only within a
    pixel of the border.
    """
    if impl == "kernel":
        fused = corner_response_fused if gray.is_cuda else corner_response_fused_reference
        return fused(gray, sigma)
    if impl != "conv":
        raise ValueError(f"impl must be 'kernel' or 'conv', got {impl!r}")
    dtype, dev = gray.dtype, gray.device
    k = _gaussian_kernel1d(sigma, int(3 * sigma + 0.5), dtype, dev)
    sm = _conv2d_separable(gray, k)
    d2 = torch.tensor([1.0, -2.0, 1.0], dtype=dtype, device=dev)
    dxy = torch.tensor(
        [[0.25, 0.0, -0.25], [0.0, 0.0, 0.0], [-0.25, 0.0, 0.25]], dtype=dtype, device=dev
    )
    Ixx = _conv2d(sm, d2[None, :])
    Iyy = _conv2d(sm, d2[:, None])
    Ixy = _conv2d(sm, dxy)
    return Ixy * Ixy - Ixx * Iyy


def find_corner_candidates(gray, max_candidates=128, nms_radius=4, sigma=1.5):
    """Top-K saddle candidates per frame after local-max NMS.

    ``gray`` (B, H, W) float in [0, 1]. Returns (xy (B, K, 2), score (B, K)):
    (x, y) pixel positions of response maxima, scores sorted descending
    (ties: lower pixel-tile index first, as ``lax.top_k``). The response
    and peak mask come from one launch of the fused corner kernel; the
    top-K is plain torch.
    """
    peaks = corner_response_peaks if gray.is_cuda else corner_response_peaks_reference
    resp, is_peak = peaks(gray, sigma=sigma, nms_radius=nms_radius)
    B, H, W = resp.shape
    dev = resp.device
    # Suppress a border strip (subpixel windows must fit inside the image).
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    margin = nms_radius + 4
    interior = (ys >= margin) & (ys < H - margin) & (xs >= margin) & (xs < W - margin)
    masked = torch.where(is_peak & interior, resp, 0.0)
    # Hierarchical top-K: NMS peaks with distinct responses are more than
    # nms_radius apart, so a t x t tile with t <= nms_radius holds at most
    # one; reduce each tile to (max, first argmax) and sort the tile maxima.
    t = max(1, min(4, nms_radius))
    if t > 1:
        pad_h, pad_w = (-H) % t, (-W) % t
        if pad_h or pad_w:
            masked = F.pad(masked, (0, pad_w, 0, pad_h))
        Ht, Wt = (H + pad_h) // t, (W + pad_w) // t
        tiles = masked.reshape(B, Ht, t, Wt, t).permute(0, 1, 3, 2, 4).reshape(B, Ht * Wt, t * t)
        tmax = tiles.amax(-1)
        targ = tiles.argmax(-1)
        score, tix = torch.sort(tmax, dim=-1, descending=True, stable=True)
        score, tix = score[:, :max_candidates], tix[:, :max_candidates]
        within = targ.gather(1, tix)
        y = ((tix // Wt) * t + within // t).to(gray.dtype)
        x = ((tix % Wt) * t + within % t).to(gray.dtype)
    else:
        flat = masked.reshape(B, -1)
        score, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
        score, idx = score[:, :max_candidates], idx[:, :max_candidates]
        y = (idx // W).to(gray.dtype)
        x = (idx % W).to(gray.dtype)
    return torch.stack([x, y], dim=-1), score


# ---------------------------------------------------------------------------
# Device stage 2: subpixel refinement (cornerSubPix equivalent)
# ---------------------------------------------------------------------------


def refine_corners_subpix(gray, corners, win_size=5, n_iters=4, max_drift=3.0):
    """Gradient-orthogonality subpixel refinement, batched over corners.

    The cornerSubPix fixed point q = (sum g g^T)^-1 sum (g g^T p) over a
    Gaussian-weighted (2 win_size + 1)^2 window, ``n_iters`` times, with each
    step clamped to 2 px and the total drift to ``max_drift``. ``gray``
    (B, H, W) in [0, 1]; ``corners`` (B, K, 2) in (x, y). Each corner's
    gradient patch is gathered once; every iteration's bilinear window is a
    weighted sum of four integer-shifted windows of that patch.
    """
    B, H, W = gray.shape
    dtype, dev = gray.dtype, gray.device
    r = win_size
    D = int(np.ceil(max_drift))
    R = r + D + 1  # patch half-extent: window + drift + bilinear support
    S = 2 * R + 1

    padded = F.pad(gray, (1, 1, 1, 1))
    gx = 0.5 * (padded[:, 1:-1, 2:] - padded[:, 1:-1, :-2])
    gy = 0.5 * (padded[:, 2:, 1:-1] - padded[:, :-2, 1:-1])

    # One patch per corner; origins clamp so the patch stays in-image.
    ox = (_f2i(torch.round(corners[..., 0])) - R).clamp(0, W - S)
    oy = (_f2i(torch.round(corners[..., 1])) - R).clamp(0, H - S)
    ar = torch.arange(S, device=dev)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    rows = (oy[..., None] + ar)[..., :, None]
    cols = (ox[..., None] + ar)[..., None, :]
    px_p = gx[bi, rows, cols]  # (B, K, S, S)
    py_p = gy[bi, rows, cols]
    origin = torch.stack([ox, oy], dim=-1).to(dtype)
    q0 = corners - origin  # patch coordinates (nominally (R, R))
    refined = _subpix_refine_patches(
        px_p, py_p, q0, win_size, max_drift=max_drift, n_iters=n_iters
    )
    return refined + origin


def _subpix_refine_patches(px_p, py_p, q0, win_size, max_drift=3.0, n_iters=4):
    """Iterate the cornerSubPix fixed point on gradient patches.

    ``px_p``/``py_p``: (..., S, S) gradient patches with
    S = 2 * (win_size + ceil(max_drift) + 1) + 1; ``q0``: (..., 2) initial
    corner in patch coordinates. Returns refined patch coordinates,
    drift-clamped to center +- max_drift.
    """
    dtype, dev = px_p.dtype, px_p.device
    r = win_size
    size = 2 * r + 1
    D = int(np.ceil(max_drift))
    R = r + D + 1
    S = 2 * R + 1
    if px_p.shape[-1] != S:
        raise ValueError(f"patch extent {px_p.shape[-1]} != {S} for win {r}, drift {D}")

    offs = torch.arange(-r, r + 1, dtype=dtype, device=dev)
    wy_g, wx_g = torch.meshgrid(offs, offs, indexing="ij")
    # cornerSubPix weight: Gaussian-ish taper over the window.
    wgt = torch.exp(-(wx_g**2 + wy_g**2) / (2.0 * (0.5 * r + 0.5) ** 2))

    lead = px_p.shape[:-2]
    gpx = px_p.reshape(-1, S, S)
    gpy = py_p.reshape(-1, S, S)
    q = q0.reshape(-1, 2)
    mi = torch.arange(gpx.shape[0], device=dev)[:, None, None]
    sel = torch.arange(size + 1, device=dev)

    for _ in range(n_iters):
        qx, qy = q[:, 0], q[:, 1]
        bx = (_f2i(torch.floor(qx)) - r).clamp(0, S - size - 1)
        by = (_f2i(torch.floor(qy)) - r).clamp(0, S - size - 1)
        fx = (qx - (bx + r).to(dtype))[:, None, None]
        fy = (qy - (by + r).to(dtype))[:, None, None]
        rws = (by[:, None] + sel)[:, :, None]
        cls = (bx[:, None] + sel)[:, None, :]

        def window(p):
            w4 = p[mi, rws, cls]  # (M, size + 1, size + 1): an exact gather
            return (
                (1 - fy) * (1 - fx) * w4[:, :-1, :-1]
                + (1 - fy) * fx * w4[:, :-1, 1:]
                + fy * (1 - fx) * w4[:, 1:, :-1]
                + fy * fx * w4[:, 1:, 1:]
            )

        gxs = window(gpx)
        gys = window(gpy)
        px = qx[:, None, None] + wx_g  # sample positions (patch coords)
        py = qy[:, None, None] + wy_g
        a = (wgt * gxs * gxs).sum((-2, -1))
        b = (wgt * gxs * gys).sum((-2, -1))
        c = (wgt * gys * gys).sum((-2, -1))
        bx_r = (wgt * (gxs * gxs * px + gxs * gys * py)).sum((-2, -1))
        by_r = (wgt * (gxs * gys * px + gys * gys * py)).sum((-2, -1))
        det = a * c - b * b
        safe = det.abs() > 1e-12
        det_s = torch.where(safe, det, 1.0)
        q_new = torch.stack(
            [(c * bx_r - b * by_r) / det_s, (a * by_r - b * bx_r) / det_s], dim=-1
        )
        # Clamp the step (degenerate windows) and the total drift.
        d = (q_new - q).clamp(-2.0, 2.0)
        stepped = (q + d).clamp(R - max_drift, R + max_drift)
        q = torch.where(safe[:, None], stepped, q)
    return q.reshape(lead + (2,))


# ---------------------------------------------------------------------------
# Host stage: lattice growth (order candidates into the board grid)
# ---------------------------------------------------------------------------
#
# A numpy copy of the JAX package's host ordering
# (multicam_calibration_tpu/detection/detector.py:349-1067); the lattice
# growth at rung 0 runs in C++ (native_lattice), as the JAX package's does.


_HOLE_TOLERANCE = 3
# Occlusion escalation: when the standard pass yields NO window, a single
# host-side retry relaxes the hole budget (a clutter object sitting ON the
# board can occlude a contiguous 4-6 corner block — no saddle exists there
# at any scale, so neither candidate search nor the coarse ladder can
# recover those cells; hard-frame bench frame 8). Escalated windows still
# face every downstream gate (lattice smoothness, anchor margin >=
# match_score_min_diff), which is what keeps a relaxed budget from
# admitting shifted/clutter windows. The budget scales with board size
# (capped at 1/7 of the corners) so small boards — where 5 holes would be
# a third of the lattice and the gates lose discriminating power — never
# escalate past the standard tolerance.
_HOLE_TOLERANCE_OCCLUDED = 5


def _escalated_hole_budget(n_corners):
    return min(_HOLE_TOLERANCE_OCCLUDED, max(_HOLE_TOLERANCE, n_corners // 7))


def _lines_cover(cells_ij, max_lines=2, tol=0.75):
    """True when the integer lattice cells are coverable by <= max_lines
    straight lines (within ``tol`` cells). An occluding bar crosses the
    board along a pixel-space line; homographies map lines to lines, so
    its killed corners are collinear in LATTICE coordinates too — the
    signature that lets the occlusion escalation accept more holes than
    the unstructured budget without admitting scattered clutter windows.
    """
    from itertools import combinations

    pts = np.asarray(cells_ij, float)
    if len(pts) <= 2 * max_lines:
        return True

    def best_line_mask(sub):
        best = None
        for a, b in combinations(range(len(sub)), 2):
            d = sub[b] - sub[a]
            nrm = np.hypot(d[0], d[1])
            if nrm < 1e-9:
                continue
            n = np.array([-d[1], d[0]]) / nrm
            m = np.abs((sub - sub[a]) @ n) <= tol
            if best is None or m.sum() > best.sum():
                best = m
        return best

    m1 = best_line_mask(pts)
    if m1 is None:
        return False
    rest = pts[~m1]
    if len(rest) <= 2:
        return True
    m2 = best_line_mask(rest)
    return m2 is not None and bool(m2.all())


def _grow_lattice_numpy(pts, sc, n_needed, pitch_tol, max_holes=None,
                        rung=0):
    """Score-filter, dedup, pitch estimate, and seeded BFS lattice growth —
    the numpy reference path (also the parity oracle for the C++ port in
    native/src/lattice.cc). Returns ``(pts, sc, pitch, grid)``: the deduped
    candidates in descending-score order (the index space of ``grid``'s
    values) and the grown lattice dict, or ``grid=None`` when no lattice
    was found."""
    hole_budget = _HOLE_TOLERANCE if max_holes is None else int(max_holes)
    # True corners score in a tight band well above clutter (saddle response
    # is contrast-normalized in practice); threshold relative to the n-th
    # strongest so the cut adapts to the scene.
    ref_score = np.sort(sc)[-n_needed]
    keep = sc > 0.35 * ref_score
    pts = pts[keep]
    sc = sc[keep]
    if len(pts) < n_needed:
        return pts, sc, 0.0, None

    # Deduplicate: subpixel refinement can collapse two distinct NMS peaks
    # onto the same corner (observed sub-px pairs on cluttered frames); a
    # near-duplicate as a seed neighbor yields a garbage lattice direction.
    # Greedy keep-strongest within a 3 px radius, vectorized: walk points in
    # score order and mask out everything a kept point suppresses (the
    # per-pair Python genexpr here was the hottest line of the host stage).
    # Stable sorts throughout: NMS candidates are integer pixel positions,
    # so exact distance/score ties happen; unstable tie-breaking made the
    # grown lattice orientation depend on quicksort partitioning (and
    # diverge from the C++ port, which sorts stably).
    order_sc = np.argsort(-sc, kind="stable")
    P = pts[order_sc]
    d2s = np.sum((P[:, None] - P[None, :]) ** 2, axis=-1)
    n = len(P)
    alive = np.ones(n, bool)
    later = np.arange(n)
    for a in range(n):
        if alive[a]:
            alive[(d2s[a] <= 9.0) & (later > a)] = False
    pts = P[alive]
    sc = sc[order_sc][alive]
    if len(pts) < n_needed:
        return pts, sc, 0.0, None

    # Pairwise distances; lattice pitch ~ nearest-neighbor spacing among
    # the TOP-n_needed candidates by score. Structured clutter (an
    # occlusion bar's edge crossing the board draws a dense LINE of
    # pseudo-corners every ~pitch/3, and gives bar-adjacent TRUE corners a
    # near clutter neighbor) contaminates the small end of the NN
    # distribution — measured: two 10 px bars drag the plain median to
    # 15-19 px on a 40 px board and detection to 0/24. The growth loop
    # therefore tries a LADDER of NN quantiles (median first — exactly the
    # historical estimate on clean frames — then upper quantiles, which
    # land on the true spacing when the lower half is clutter).
    d2 = d2s[np.ix_(alive, alive)]
    np.fill_diagonal(d2, np.inf)
    top = min(n_needed, len(pts))
    pitch = np.median(np.sqrt(d2[:top, :top].min(axis=1)))

    used_mask = np.zeros(len(pts), bool)

    def nearest(target, tol):
        """Nearest unused candidate to ``target`` within ``tol`` (squared
        comparisons; ``used_mask`` maintained by the growth loop)."""
        dd = np.sum((pts - target) ** 2, axis=-1)
        dd[used_mask] = np.inf
        j = int(np.argmin(dd))
        return (j, dd[j]) if dd[j] < tol * tol else (None, None)

    # Seed candidates: closest to the cloud centroid first (likely interior
    # vertices); clutter can still land there, so retry growth from the next
    # few seeds before giving up.
    centroid = pts.mean(0)
    seed_order = np.argsort(
        np.sum((pts - centroid) ** 2, axis=-1), kind="stable"
    )

    def grow_from(seed, rung):
        """Grow from ``seed``; returns (grid_or_None, pitch_used).

        Rung 0 is the historical growth: basis vectors from the seed's
        absolute nearest neighbors, admission tolerance from the global
        median pitch. Upper rungs handle STRUCTURED clutter (an occlusion
        bar's edge draws a dense line of pseudo-corners a fraction of the
        board pitch apart, poisoning both the median and the seed's
        nearest neighbor): rung r takes the seed's r-th distinct
        neighbor-DISTANCE SCALE (scales separated by >1.5x) as the pitch
        hypothesis and picks basis vectors within that scale's band. The
        caller accepts a rung only when window extraction succeeds.
        """
        order = np.argsort(d2[seed], kind="stable")
        if rung == 0:
            cand_idx = [int(j) for j in order[:6]]
            p = pitch
        else:
            ds = np.sqrt(d2[seed][order[:12]])
            finite = ds[np.isfinite(ds)]
            scale_ix = [0]
            for k in range(1, len(finite)):
                if finite[k] > 1.5 * finite[scale_ix[-1]]:
                    scale_ix.append(k)
            if rung >= len(scale_ix):
                return None, pitch
            p = float(finite[scale_ix[rung]])
            in_band = (ds >= 0.7 * p) & (ds <= 1.45 * p)
            cand_idx = [int(order[k]) for k in range(len(ds)) if in_band[k]]
        if not cand_idx:
            return None, p
        v1 = pts[cand_idx[0]] - pts[seed]
        first = cand_idx[0]
        v2 = None
        for j in cand_idx[1:6]:
            cand = pts[j] - pts[seed]
            cosang = abs(np.dot(cand, v1)) / (
                np.linalg.norm(cand) * np.linalg.norm(v1) + 1e-30
            )
            if cosang < 0.7:  # > ~45 degrees apart
                v2 = cand
                break
        if v2 is None:
            return None, p

        grid = {(0, 0): seed, (1, 0): first}
        # Virtual vertices: a lattice cell with no candidate (a hole —
        # dimmed saddle, occlusion, weak pseudo-corner filtered by the
        # score cut) must not BLOCK the BFS, or the reachable region —
        # and hence whether the board survives at all — depends on which
        # side of the hole the growth happened to start from (observed:
        # identical candidates grew 33 cells from one seed-neighbor
        # tie-break and 30 from the other). When no candidate matches, we
        # place a scaffold vertex at the predicted position and keep
        # growing through it; scaffolds never chain (a new scaffold needs
        # a REAL extrapolation predecessor), which bounds them to one ring
        # past the real lattice. They are dropped from the returned grid —
        # downstream window scoring counts them as holes as before.
        vpos = {}  # (i, j) -> predicted position of scaffold cells

        def pos(idx, cell):
            return pts[idx] if idx >= 0 else vpos[cell]

        used_mask[:] = False
        used_mask[seed] = used_mask[first] = True
        j2, _ = nearest(pts[seed] + v2, pitch_tol * p * 2)
        if j2 is None:
            return None, p
        grid[(0, 1)] = j2
        used_mask[j2] = True

        # BFS growth: predict each new vertex by linear extrapolation from
        # two collinear predecessors (local step adapts to perspective and,
        # to first order, lens distortion).
        frontier = list(grid.keys())
        while frontier:
            new_frontier = []
            for (i, j) in frontier:
                for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    tgt = (i + di, j + dj)
                    # A scaffold cell stays open to UPGRADE: the first
                    # (failed) visit predicted from one direction only; a
                    # real candidate may still match a later visit's
                    # prediction from an orthogonal direction (the
                    # pre-scaffold behavior, where unfilled cells were
                    # retried on every ring). Real cells are final.
                    if grid.get(tgt, -1) >= 0:
                        continue
                    # Prefer extrapolation from predecessors along (di, dj).
                    p1 = grid.get((i, j))
                    p0 = grid.get((i - di, j - dj))
                    if p0 is not None:
                        pred = 2 * pos(p1, (i, j)) - pos(p0, (i - di, j - dj))
                    else:
                        # Parallel step copied from a neighbor row.
                        pred = None
                        for oi, oj in ((dj, di), (-dj, -di)):
                            a = grid.get((i + oi, j + oj))
                            b = grid.get((i + oi + di, j + oj + dj))
                            if a is not None and b is not None:
                                pred = pos(p1, (i, j)) + (
                                    pos(b, (i + oi + di, j + oj + dj))
                                    - pos(a, (i + oi, j + oj))
                                )
                                break
                        if pred is None:
                            continue
                    cand, _ = nearest(pred, pitch_tol * p)
                    if cand is not None:
                        grid[tgt] = cand
                        vpos.pop(tgt, None)
                        used_mask[cand] = True
                        new_frontier.append(tgt)
                    elif p1 >= 0 and tgt not in grid:
                        # No candidate: scaffold through the hole (only
                        # from a real predecessor — scaffolds don't chain,
                        # and a cell is scaffolded at most once).
                        grid[tgt] = -1
                        vpos[tgt] = pred
                        new_frontier.append(tgt)
            frontier = new_frontier
        real = {c: idx for c, idx in grid.items() if idx >= 0}
        # Up to max_holes lattice holes are tolerated downstream (window
        # cells filled by homography prediction) — requiring a full
        # n_needed here would veto exactly the grids the hole tolerance
        # exists for.
        return (real, p) if len(real) >= n_needed - hole_budget else (None, p)

    # Rung 0 is the exact historical growth; upper rungs re-grow at the
    # seed's higher neighbor-distance scales. The CALLER walks rungs —
    # growth at a clutter pitch can "succeed" with a bogus fine lattice
    # that only window extraction can reject, so rung acceptance belongs
    # at the window level (order_grid_points).
    grid = None
    for seed in seed_order[:5]:
        grid, p_used = grow_from(int(seed), rung)
        if grid is not None:
            pitch = p_used
            break
    return pts, sc, pitch, grid


def _grow_lattice(pts, sc, n_needed, pitch_tol, max_holes=None, rung=0):
    """Lattice growth, routed as the JAX package routes it: the native C++
    build (``native_lattice``) at rung 0 with the default hole budget, the
    numpy path for an escalated ``max_holes``, an upper pitch-ladder
    ``rung``, or when the environment sets ``MCC_NO_NATIVE_LATTICE``. The
    two keep the same candidates, pitch and corner set, and the same
    lattice up to coordinate symmetry. A failed native build raises."""
    if rung == 0 and (max_holes is None or max_holes == _HOLE_TOLERANCE) \
            and native_lattice.enabled():
        return native_lattice.grow_lattice(pts, sc, n_needed, pitch_tol)
    return _grow_lattice_numpy(pts, sc, n_needed, pitch_tol, max_holes,
                               rung=rung)


def order_grid_points(
    candidates, scores, board_shape, pitch_tol=0.35, refined=True,
    position_jitter=0.5, n_windows=1, return_masks=False, max_holes=None,
):
    """Assemble the (rows x cols) chessboard lattice from corner candidates.

    Grid growth with local step prediction (handles perspective): seed at
    the strongest candidate, discover its lattice neighbors, then BFS
    outward predicting each next vertex from its two predecessors along the
    row/column. Pure numpy on <=128 points — this combinatorial step is the
    one part of detection that does not belong on the accelerator.

    Returns uvs (rows*cols, 2) ordered row-major (orientation arbitrary up
    to flips/transpose — resolved later by anchor matching), or None.
    With ``return_masks=True``, each window comes as ``(uvs, constructed)``
    where ``constructed`` is a (rows*cols,) bool marking cells that were
    homography-predicted (holes / weak pseudo-corners) rather than measured
    — downstream validation exempts them from the outlier criteria.
    ``max_holes`` overrides the default hole budget (``_HOLE_TOLERANCE``)
    for the occlusion-escalation retry.
    """
    rows, cols = board_shape
    n_needed = rows * cols
    hole_budget = _HOLE_TOLERANCE if max_holes is None else int(max_holes)
    # Structured-occlusion extension (escalated retries only): an occluding
    # bar kills up to max(rows, cols) corners along ONE line — more than
    # any scattered-hole budget can safely admit. Windows whose missing
    # cells exceed ``hole_budget`` are still accepted up to
    # ``struct_budget`` when the misses are coverable by <= 2 lattice
    # lines (_lines_cover); anchor margin + smoothness still gate them.
    escalated = max_holes is not None and max_holes > _HOLE_TOLERANCE
    struct_budget = (
        min(2 * max(rows, cols), n_needed // 3) if escalated else hole_budget
    )
    struct_budget = max(struct_budget, hole_budget)
    _empty = None if n_windows == 1 else []
    pts_in = np.asarray(candidates, dtype=float)
    sc_in = np.asarray(scores, dtype=float)
    if len(pts_in) < n_needed:
        return _empty

    def _extract(pts, sc, pitch, grid):

        # Extract the BEST complete window whose spans match {rows, cols}: BFS
        # growth can absorb lattice-consistent clutter corners just off the
        # board, creating several complete windows; true board corners carry the
        # strongest saddle scores, so rank windows by (min cell score, total
        # score) — a window containing even one clutter cell loses on the min.
        # Output follows the REFERENCE's uvs convention: consecutive points step
        # along the board_shape[0]-point axis, i.e. uvs.reshape(board_shape[1],
        # board_shape[0], 2) recovers the lattice (detection.py:461 reshape).
        keys = np.array(list(grid.keys()))
        imin, jmin = keys.min(0)
        imax, jmax = keys.max(0)
        windows = []
        for (nr, nc) in ((cols, rows), (rows, cols)):
            for i0 in range(imin, imax - nr + 2):
                for j0 in range(jmin, jmax - nc + 2):
                    cells = [(i0 + a, j0 + b) for a in range(nr) for b in range(nc)]
                    present = [c for c in cells if c in grid]
                    # Cheap early-out: weak-counting below only ever INCREASES
                    # the number of holes, so windows already over the
                    # tolerance skip the score/median work (this loop
                    # enumerates hundreds of positions on clutter-grown grids).
                    if len(cells) - len(present) > struct_budget:
                        continue
                    cell_sc = np.array([sc[grid[c]] for c in present])
                    # Cells whose saddle score sits far below the window's own
                    # median are board-boundary / clutter pseudo-corners, not
                    # chessboard corners (measured on the hard-frame bench:
                    # fakes <= 0.32x median, dim-but-true corners >= 0.64x).
                    # Count them as holes: a window shifted onto the board
                    # margin then exceeds the hole tolerance and loses to the
                    # true window, instead of outranking it as "complete".
                    weak = cell_sc < 0.45 * np.median(cell_sc)
                    good = frozenset(
                        c for c, w in zip(present, weak) if not w
                    )
                    n_missing = len(cells) - len(good)
                    # Tolerate a few holes: a clutter overhang or a dimmed
                    # saddle can push 1-3 true corners out of the candidate
                    # top-K (or below the weak-score cut), which otherwise
                    # vetoes the whole board. Holes are filled by homography
                    # prediction below; complete windows always outrank holed
                    # ones, and shifted windows carry >= 5 pseudo-corners so
                    # the tolerance never admits them.
                    if n_missing > struct_budget:
                        continue
                    if n_missing > hole_budget:
                        missing = [c for c in cells if c not in good]
                        if not _lines_cover(missing):
                            continue
                        # A window shifted half off the board ALSO loses a
                        # collinear set — exactly its boundary row/col. An
                        # occluder crosses the interior; reject structured
                        # windows whose loss is a whole window boundary.
                        mset = set(missing)
                        edge = False
                        for line in (
                            [cells[b] for b in range(nc)],
                            [cells[(nr - 1) * nc + b] for b in range(nc)],
                        ):
                            edge |= sum(c in mset for c in line) >= nc - 1
                        for line in (
                            [cells[a * nc] for a in range(nr)],
                            [cells[a * nc + nc - 1] for a in range(nr)],
                        ):
                            edge |= sum(c in mset for c in line) >= nr - 1
                        if edge:
                            continue
                        # A lattice grown at HALF the true pitch aliases:
                        # its interleaved lines land mid-square where no
                        # saddle exists, so complete lattice-parallel lines
                        # at EVERY OTHER index go missing. Two parallel
                        # occluding bars also lose two full lines, but at
                        # arbitrary spacing — reject only the period-2
                        # pattern.
                        full_rows = [
                            a for a in range(nr)
                            if all((i0 + a, j0 + b) in mset for b in range(nc))
                        ]
                        full_cols = [
                            b for b in range(nc)
                            if all((i0 + a, j0 + b) in mset for a in range(nr))
                        ]
                        alias = any(
                            len(fl) >= 2
                            and all(np.diff(fl) == 2)
                            for fl in (full_rows, full_cols)
                        )
                        if alias:
                            continue
                    good_sc = cell_sc[~weak]
                    windows.append(
                        (
                            (-n_missing, good_sc.min(), good_sc.sum()),
                            (nr, nc),
                            cells,
                            good,
                        )
                    )
        windows.sort(key=lambda wdw: wdw[0], reverse=True)

        def fill_holes(cells, good, assign):
            """Pixel positions for a window, homography-predicting missing or
            weak (pseudo-corner) cells from the good ones (plain numpy DLT —
            this host helper must not dispatch to a device)."""
            present = [(c, pts[assign[c]]) for c in cells if c in good]
            if len(present) == len(cells):
                return np.stack([p for _, p in present])
            src = np.array([c for c, _ in present], float)
            dst = np.stack([p for _, p in present])
            Hm = _dlt_homography_np(src, dst)
            lookup = dict(present)
            out = []
            for c in cells:
                if c in lookup:
                    out.append(lookup[c])
                else:
                    v = Hm @ np.array([c[0], c[1], 1.0])
                    out.append(v[:2] / v[2])
            return np.stack(out)

        def smooth_enough(uv_grid):
            # Lattice validity: second differences along each axis measure the
            # local curvature of the point grid. A genuine board is smooth even
            # under strong lens distortion/perspective (measured max ~0.8 px at
            # k1=-0.28); a clutter-substituted cell jumps by ~0.35*pitch (the
            # BFS admission tolerance, ~10 px). Threshold well between the two.
            # Unrefined (integer NMS) positions carry up to +-0.5 px rounding
            # per point -> up to 2 px of extra second difference; callers that
            # order before subpixel refinement (refined=False) re-validate with
            # the strict limit after refining (see _grid_smoothness_ok).
            lim = max(0.15 * pitch, 2.5) + (0.0 if refined else 4.0 * position_jitter)
            for ax in (0, 1):
                d2d = np.diff(uv_grid, n=2, axis=ax)
                if d2d.size and np.linalg.norm(d2d, axis=-1).max() > lim:
                    return False
            return True

        def lattice_ends_at(uv_grid):
            """True when no candidate line continues TWO lattice steps
            beyond the window boundary. A window grown at HALF the true
            pitch (or shifted onto part of a larger structure) covers only
            part of the board: two of its steps beyond the boundary land
            back on real board corners. A correct window's +2 line lies in
            the blank margin — one step PAST the board-edge T-junction
            saddles, which is why +1 cannot discriminate (measured: the
            true window's +1 line hits 4-7 T-junction candidates)."""
            for ax in (0, 1):
                g = uv_grid if ax == 0 else uv_grid.transpose(1, 0, 2)
                for ext in (3 * g[0] - 2 * g[1], 3 * g[-1] - 2 * g[-2]):
                    dmin = np.sqrt(
                        ((pts[None] - ext[:, None]) ** 2).sum(-1).min(1)
                    )
                    hits = int((dmin < 0.3 * pitch).sum())
                    # A continuing lattice populates most of the line; an
                    # occluder's clutter trail crosses it in 1-2 cells.
                    if hits >= max(3, int(0.6 * len(ext))):
                        return False
            return True

        def ghost_of(cells, good, uv_grid, assign):
            """True when the window's measured cells have a coherent
            TRANSLATED COPY among the unused candidates. Motion blur splits
            every saddle into two displaced ghosts; a lattice grown on one
            ghost family is complete, smooth and homographic — but no real
            board has a uniformly-offset duplicate of itself. Rejected
            frames fall through to the coarse-sigma rungs, which see the
            blur's own scale and find the true (centered) lattice."""
            mcells = [c for c in cells if c in good]
            if len(mcells) < 8:
                return False
            used = {assign[c] for c in mcells}
            P = np.stack([pts[assign[c]] for c in mcells])
            unused = np.array(
                [i for i in range(len(pts)) if i not in used], dtype=int
            )
            if len(unused) == 0:
                return False
            d01 = np.linalg.norm(np.diff(uv_grid, axis=0), axis=-1)
            d02 = np.linalg.norm(np.diff(uv_grid, axis=1), axis=-1)
            pw = float(np.median(np.concatenate([d01.ravel(), d02.ravel()])))
            D = pts[unused][None] - P[:, None]  # (m, u, 2)
            nrm = np.linalg.norm(D, axis=-1)
            offs = D[(nrm > 3.0) & (nrm < 0.7 * pw)]
            if len(offs) < 0.5 * len(P):
                return False
            dd = np.linalg.norm(offs[:, None] - offs[None], axis=-1)
            return int((dd < 1.5).sum(1).max()) >= 0.6 * len(P)

        def positional_gates(cells, good, assign, nr, nc, n_missing):
            """Gates on the window's pixel geometry; uv_grid or None."""
            uvs = fill_holes(cells, good, assign)
            uv_grid = uvs.reshape(nr, nc, 2)
            if not smooth_enough(uv_grid):
                return None
            if ghost_of(cells, good, uv_grid, assign):
                return None
            if n_missing > hole_budget:
                # Structured-budget window: the board must END here...
                if not lattice_ends_at(uv_grid):
                    return None
                # ...and with this many homography-FILLED cells, the
                # measured cells must actually be homographic (rms < 1 px).
                # Blur smears refinement and lens distortion bends the
                # lattice; either way the fills extrapolate wrong and a
                # plausible-looking corrupt grid slips through (measured:
                # blur_16/24px suites admitted mean-5px grids without this).
                mcells = [c for c in cells if c in good]
                src = np.array(mcells, float)
                dst = np.stack([pts[assign[c]] for c in mcells])
                Hm = _dlt_homography_np(src, dst)
                pr = np.concatenate(
                    [src, np.ones((len(src), 1))], 1
                ) @ Hm.T
                pr = pr[:, :2] / pr[:, 2:]
                if float(np.sqrt(((pr - dst) ** 2).sum(1).mean())) > 1.0:
                    return None
            return uv_grid

        def structural_gates(cells, good, nr, nc):
            """Hole-structure gates (re-run after a repair changes the
            good-set): budget, <=2-line coverage, boundary/aliasing."""
            n_missing = len(cells) - len(good)
            if n_missing > struct_budget:
                return False
            if n_missing <= hole_budget:
                return True
            missing = [c for c in cells if c not in good]
            if not _lines_cover(missing):
                return False
            mset = set(missing)
            edge = False
            for line in (
                [cells[b] for b in range(nc)],
                [cells[(nr - 1) * nc + b] for b in range(nc)],
            ):
                edge |= sum(c in mset for c in line) >= nc - 1
            for line in (
                [cells[a * nc] for a in range(nr)],
                [cells[a * nc + nc - 1] for a in range(nr)],
            ):
                edge |= sum(c in mset for c in line) >= nr - 1
            if edge:
                return False
            full_rows = [
                a for a in range(nr)
                if all(cells[a * nc + b] in mset for b in range(nc))
            ]
            full_cols = [
                b for b in range(nc)
                if all(cells[a * nc + b] in mset for a in range(nr))
            ]
            return not any(
                len(fl) >= 2 and all(np.diff(fl) == 2)
                for fl in (full_rows, full_cols)
            )

        def repair_window(cells):
            """Global homography-refit re-assignment (host analogue of the
            device path's refit ordering). BFS growth admits an occlusion
            bar's edge pseudo-corners — they sit within the admission
            tolerance of the predicted cell — and every cell extrapolated
            THROUGH them inherits the displacement, so the whole window
            fails the smoothness/homography gates even though most cells
            are true corners. The majority is still right: refit H on the
            current assignment, snap every cell to its nearest candidate
            near the H-prediction (injectively), iterate to a fixed point.
            Gates re-run on the repaired window, so a repair can only ever
            PROPOSE — it cannot admit a window the gates would reject."""
            assign = {c: grid[c] for c in cells if c in grid}
            if len(assign) < 10:
                return None
            tol = max(2.5, 0.2 * pitch)
            cells_f = np.concatenate(
                [np.array(cells, float), np.ones((len(cells), 1))], 1
            )
            for _ in range(3):
                src = np.array(list(assign), float)
                dst = np.stack([pts[assign[c]] for c in assign])
                Hm = _dlt_homography_np(src, dst)
                pr = cells_f @ Hm.T
                pr = pr[:, :2] / pr[:, 2:]
                dd = np.linalg.norm(pts[None, :] - pr[:, None], axis=-1)
                new, owner = {}, {}
                for k, c in enumerate(cells):
                    j = int(np.argmin(dd[k]))
                    if dd[k, j] >= tol:
                        continue
                    if j in owner:
                        k0, c0 = owner[j]
                        if dd[k0, j] <= dd[k, j]:
                            continue
                        del new[c0]
                    owner[j] = (k, c)
                    new[c] = j
                if len(new) < 10:
                    return None
                if new == assign:
                    break
                assign = new
            cell_sc = np.array([sc[assign[c]] for c in assign])
            good = frozenset(
                c for c, s_ in zip(assign, cell_sc)
                if s_ >= 0.45 * np.median(cell_sc)
            )
            return {c: assign[c] for c in good}, good

        results = []
        seen_cells = []
        n_repairs = 0
        failed_repairs = []
        for key, (nr, nc), cells, good in windows:
            assign = {c: grid[c] for c in cells if c in good}
            uv_grid = positional_gates(cells, good, assign, nr, nc, -key[0])
            # Don't burn the repair budget on near-duplicates of a window
            # whose repair already failed: clutter-grown lattices emit many
            # shifted windows sharing most cells, and sort order would
            # otherwise exhaust the budget before the true window is tried.
            cellset_now = frozenset(cells)
            dup_failed = any(
                len(cellset_now & f) >= 0.75 * len(cellset_now)
                for f in failed_repairs
            )
            if uv_grid is None and escalated and n_repairs < 12 \
                    and not dup_failed:
                # Escalated retries only: repair is for structured
                # occlusion (bar-edge clutter), and the standard pass
                # already found nothing on these frames.
                n_repairs += 1
                rep = repair_window(cells)
                # Accept when the ASSIGNMENT changed, not just the good-cell
                # set: a repair that re-snaps the same good cells to
                # different candidates (the pseudo-corner-swap case the
                # repair targets) must not be silently discarded.
                if rep is not None and (rep[0] != assign or rep[1] != good):
                    assign2, good2 = rep
                    if structural_gates(cells, good2, nr, nc):
                        uv2 = positional_gates(
                            cells, good2, assign2, nr, nc,
                            len(cells) - len(good2),
                        )
                        if uv2 is not None:
                            uv_grid, good, assign = uv2, good2, assign2
                if uv_grid is None:
                    failed_repairs.append(cellset_now)
            if uv_grid is None:
                continue
            cellset = frozenset(cells)
            if cellset in seen_cells:
                continue
            seen_cells.append(cellset)
            con_grid = np.array([c not in good for c in cells]).reshape(nr, nc)
            if (nr, nc) == (rows, cols):
                # Make axis0 the cols-count axis.
                uv_grid = uv_grid.transpose(1, 0, 2)
                con_grid = con_grid.T
            if return_masks:
                results.append((uv_grid.reshape(-1, 2), con_grid.reshape(-1)))
            else:
                results.append(uv_grid.reshape(-1, 2))
            if len(results) >= n_windows:
                break
        return results

    # Pitch-ladder rungs: rung 0 is the historical median-pitch growth
    # (native C++ when available); upper rungs re-grow at higher NN
    # quantiles when no acceptable window emerged — structured clutter
    # (occlusion-bar edges) poisons the median AND can grow a bogus fine
    # lattice that only window extraction rejects, so rung acceptance
    # lives here, behind the window gates.
    results = []
    for rung in range(3):
        # Growth tolerates up to the structured budget of missing real
        # cells — the per-window line-structure test above decides whether
        # the excess is occlusion-shaped.
        pts, sc, pitch, grid = _grow_lattice(
            pts_in, sc_in, n_needed, pitch_tol,
            struct_budget if escalated else max_holes, rung=rung,
        )
        if grid is None:
            continue
        results = _extract(pts, sc, pitch, grid)
        if results:
            break
    if n_windows == 1:
        return results[0] if results else None
    return results


# ---------------------------------------------------------------------------
# Device fast-path lattice ordering
# ---------------------------------------------------------------------------
#
# Easy frames (one complete board, no holes, no weak cells) are ordered on
# the device for the whole batch at once: seed an affine basis from the
# centroid candidate's two lattice neighbours, then iterate (assign every
# candidate an integer lattice cell through H^-1, refit H by weighted DLT
# over the inliers). Frames it cannot certify (ok=False) fall back to the
# host path; the acceptance rules mirror order_grid_points', so a certified
# window is the window the host would have produced.

_FAST_ITERS = 4  # homography refit rounds (affine -> projective)


@with_highest_precision
def _order_grids_device(xy, sc, rows, cols, position_jitter=0.5, min_candidate_sep=0.0):
    """Batched device lattice ordering: (B, K, 2), (B, K) -> (uv (B, cols,
    rows, 2), ok (B,)).

    Candidates come from find_corner_candidates (scores sorted descending).
    Mirrors the host path's candidate filtering (0.35x score cut, 3 px
    greedy dedup, median-NN pitch over the top n) and acceptance (complete
    window, no weak cell by the 0.45x-median rule, second-difference
    smoothness); rejected frames get a benign canonical grid and ok=False.
    ``min_candidate_sep``: a guaranteed lower bound on the candidates'
    pairwise distance (NMS radius + 1); above 3 px the dedup is a no-op and
    is skipped.
    """
    B, K = sc.shape
    n_needed = rows * cols
    f, dev = xy.dtype, xy.device
    ys_c, xs_c = torch.meshgrid(
        torch.arange(cols, device=dev), torch.arange(rows, device=dev), indexing="ij"
    )
    canon = (torch.stack([xs_c, ys_c], dim=-1) + 32).to(f)  # (cols, rows, 2)
    if K < n_needed:  # fewer candidate slots than board corners: defer
        return canon.expand(B, cols, rows, 2).clone(), torch.zeros(B, dtype=torch.bool, device=dev)
    bidx = torch.arange(B, device=dev)
    idxk = torch.arange(K, device=dev)
    smax = 2 * max(rows, cols) + 5  # lattice-coord grid span
    off = smax // 2

    # Candidate filtering (host parity: _grow_lattice_numpy).
    ref_score = sc[:, n_needed - 1 : n_needed]
    valid = (sc > 0) & (sc > 0.35 * ref_score)
    d2_all = ((xy[:, :, None] - xy[:, None, :]) ** 2).sum(-1)
    if min_candidate_sep > 3.0:
        alive = valid  # dedup provably a no-op (see docstring)
    else:
        # Greedy keep-strongest within 3 px, in score order.
        alive = valid
        for a in range(K):
            alive = alive & ~(alive[:, a : a + 1] & (d2_all[:, a] <= 9.0) & (idxk > a))
    n_valid = alive.sum(-1)

    # Pitch: median nearest-neighbour distance among the top-n alive.
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    topm = alive & (torch.cumsum(alive.to(torch.int64), -1) <= n_needed)
    n_top = topm.sum(-1)
    pair = topm[:, :, None] & topm[:, None, :] & ~eye
    nnd = torch.sqrt(torch.where(pair, d2_all, _INF).amin(-1))
    snn = torch.sort(torch.where(topm, nnd, _INF), dim=-1).values
    lo = ((n_top - 1) // 2).clamp(0, K - 1)
    hi = (n_top // 2).clamp(0, K - 1)
    pitch = 0.5 * (snn.gather(1, lo[:, None])[:, 0] + snn.gather(1, hi[:, None])[:, 0])
    pair = alive[:, :, None] & alive[:, None, :] & ~eye
    d2 = torch.where(pair, d2_all, _INF)

    # Seed at the candidate closest to the cloud centroid; basis vectors from
    # its nearest neighbour (v1) and the first of the next five at > ~45
    # degrees (v2).
    w = alive.to(f)
    centroid = (xy * w[..., None]).sum(1) / torch.clamp(w.sum(1), min=1.0)[:, None]
    seed = torch.where(alive, ((xy - centroid[:, None]) ** 2).sum(-1), _INF).argmin(-1)
    p0 = xy[bidx, seed]
    d2s = d2[bidx, seed]
    nb = torch.argsort(d2s, dim=-1, stable=True)
    v1 = xy[bidx, nb[:, 0]] - p0
    vc = xy[bidx[:, None], nb[:, 1:6]] - p0[:, None]
    cosang = (vc * v1[:, None]).sum(-1).abs() / (
        torch.linalg.vector_norm(vc, dim=-1) * torch.linalg.vector_norm(v1, dim=-1)[:, None]
        + 1e-30
    )
    okv2 = (cosang < 0.7) & torch.isfinite(d2s.gather(1, nb[:, 1:6]))
    has_v2 = okv2.any(-1)
    v2 = vc[bidx, okv2.to(torch.uint8).argmax(-1)]

    zero = torch.zeros(B, dtype=f, device=dev)
    one = torch.ones(B, dtype=f, device=dev)
    H = torch.stack(
        [
            torch.stack([v1[:, 0], v2[:, 0], p0[:, 0]], -1),
            torch.stack([v1[:, 1], v2[:, 1], p0[:, 1]], -1),
            torch.stack([zero, zero, one], -1),
        ],
        dim=-2,
    )
    tol = (0.35 * pitch)[:, None]  # BFS admission tolerance (pitch_tol parity)
    ones_k = torch.ones((B, K, 1), dtype=f, device=dev)
    ph = torch.cat([xy, ones_k], dim=-1)

    def assign(H):
        """Integer lattice cells of every candidate under H, with the pixel
        residual of the rounded cell's prediction."""
        lp = ph @ inv3x3(H).transpose(-1, -2)
        c = torch.round(lp[..., :2] / lp[..., 2:])
        q = torch.cat([c, ones_k], dim=-1) @ H.transpose(-1, -2)
        resid = torch.linalg.vector_norm(xy - q[..., :2] / q[..., 2:], dim=-1)
        inrange = (c.abs() <= off - 1).all(-1)
        return c, resid, alive & inrange & (resid < tol)

    for _ in range(_FAST_ITERS):
        c, _, inl = assign(H)
        # Refit only with a healthy inlier count; a degenerate round keeps H.
        refit = fit_homography(c.clamp(-off, off), xy, weights=inl.to(f), method="solve")
        H = torch.where((inl.sum(-1) >= 8)[:, None, None], refit, H)
    c, resid, inl = assign(H)

    # Cell contention: strongest score wins a cell (residual tiebreak).
    ci = _f2i(c[..., 0] + off).clamp(0, smax - 1)
    cj = _f2i(c[..., 1] + off).clamp(0, smax - 1)
    flat = ci * smax + cj
    key = torch.where(inl, sc - 1e-6 * resid, -_INF)
    cell_best = torch.full((B, smax * smax), -_INF, dtype=f, device=dev).scatter_reduce(
        1, flat, key, "amax", include_self=True
    )
    winner = inl & (key >= cell_best.gather(1, flat))
    cell_idx = torch.full((B, smax * smax), -1, dtype=torch.int64, device=dev).scatter_reduce(
        1, flat, torch.where(winner, idxk, -1), "amax", include_self=True
    )
    occ = (cell_idx >= 0).reshape(B, smax, smax)
    sc_cell = torch.where(
        cell_idx >= 0, sc.gather(1, cell_idx.clamp(min=0)), 0.0
    ).reshape(B, smax, smax)

    # Rank all window placements in both orientations: complete windows
    # only, by (min cell score, total score) via min + eps * sum, normalized
    # by the frame's top score; windows with weak cells are demoted.
    mref = sc[:, 0].clamp(min=1e-12)[:, None, None]

    def windows(nr, nc):
        def unf(x):
            return x.unfold(1, nr, 1).unfold(2, nc, 1)

        cnt = unf(occ.to(f)).sum((-2, -1))
        mn = unf(torch.where(occ, sc_cell, _INF)).amin((-2, -1))
        sm = unf(sc_cell).sum((-2, -1))
        strong = (mn >= 0.45 * sm / n_needed).to(f)
        return torch.where(
            cnt >= n_needed - 0.5,
            2.0 * strong + mn / mref + 1e-6 * sm / (n_needed * mref),
            -_INF,
        )

    key_a = windows(cols, rows)  # orientation A first: host scan order
    key_b = windows(rows, cols)
    na, nbk = key_a[0].numel(), key_b[0].numel()
    flatkeys = torch.cat([key_a.reshape(B, -1), key_b.reshape(B, -1)], dim=1)
    bi = flatkeys.argmax(-1)
    found = flatkeys.gather(1, bi[:, None])[:, 0] > -_INF
    is_a = bi < na
    wa = smax - rows + 1  # key_a row width
    wb = smax - cols + 1
    bia = bi.clamp(0, na - 1)
    bib = (bi - na).clamp(0, nbk - 1)
    grid2 = cell_idx.reshape(B, smax, smax)
    ar_c = torch.arange(cols, device=dev)
    ar_r = torch.arange(rows, device=dev)
    b3 = bidx[:, None, None]
    sel_a = grid2[b3, (bia // wa)[:, None, None] + ar_c[:, None], (bia % wa)[:, None, None] + ar_r]
    sel_b = grid2[
        b3, (bib // wb)[:, None, None] + ar_r[:, None], (bib % wb)[:, None, None] + ar_c
    ].transpose(1, 2)
    cell_sel = torch.where(is_a[:, None, None], sel_a, sel_b)  # (B, cols, rows)
    uv = xy[b3, cell_sel.clamp(min=0)]

    # Weak-cell rule (0.45x window median): the host would count a hole.
    wsc = torch.sort(sc.gather(1, cell_sel.clamp(min=0).reshape(B, -1)), dim=-1).values
    med = 0.5 * (wsc[:, (n_needed - 1) // 2] + wsc[:, n_needed // 2])
    no_weak = wsc[:, 0] >= 0.45 * med

    # Unrefined-lattice smoothness (order_grid_points' smooth_enough).
    lim = torch.clamp(0.15 * pitch, min=2.5) + 4.0 * position_jitter
    smooth = torch.ones(B, dtype=torch.bool, device=dev)
    if cols >= 3:
        dd = uv[:, 2:] - 2 * uv[:, 1:-1] + uv[:, :-2]
        smooth = smooth & (torch.linalg.vector_norm(dd, dim=-1).amax((1, 2)) <= lim)
    if rows >= 3:
        dd = uv[:, :, 2:] - 2 * uv[:, :, 1:-1] + uv[:, :, :-2]
        smooth = smooth & (torch.linalg.vector_norm(dd, dim=-1).amax((1, 2)) <= lim)

    ok = (
        (n_valid >= n_needed)
        & has_v2
        & found
        & no_weak
        & smooth
        & torch.isfinite(pitch)
        & (pitch > 3.0)
        & (cell_sel >= 0).all(-1).all(-1)
    )
    return torch.where(ok[:, None, None, None], uv, canon), ok


def _dlt_homography_np(src, dst):
    """Plain-numpy DLT homography src -> dst (host helper; must not
    dispatch to a device). Rows [x, y, 1, 0, 0, 0, -ux, -uy, -u],
    [0, 0, 0, x, y, 1, -vx, -vy, -v]."""
    src = np.asarray(src, float)
    dst = np.asarray(dst, float)
    n = len(src)
    A = np.zeros((2 * n, 9))
    A[0::2, 0:2] = src
    A[0::2, 2] = 1
    A[0::2, 6:8] = -src * dst[:, 0:1]
    A[0::2, 8] = -dst[:, 0]
    A[1::2, 3:5] = src
    A[1::2, 5] = 1
    A[1::2, 6:8] = -src * dst[:, 1:2]
    A[1::2, 8] = -dst[:, 1]
    return np.linalg.svd(A)[2][-1].reshape(3, 3)


def _lattice_residuals(uv_grid, constructed=None):
    """Per-cell residuals (px) of the best global homography
    canonical-grid -> uv, shape (nr, nc). With ``constructed`` set, the
    homography is fitted to MEASURED cells only (constructed cells are
    interpolations — letting them steer the fit would mask a genuinely
    corrupted measured cell); residuals are still reported for all cells.
    """
    nr, nc = uv_grid.shape[:2]
    src = np.array([(i, j) for i in range(nr) for j in range(nc)], float)
    dst = uv_grid.reshape(-1, 2).astype(float)
    if constructed is not None and constructed.any():
        meas = ~constructed.reshape(-1)
        Hm = _dlt_homography_np(src[meas], dst[meas])
    else:
        Hm = _dlt_homography_np(src, dst)
    ph = np.concatenate([src, np.ones((len(src), 1))], axis=1) @ Hm.T
    res = np.linalg.norm(ph[:, :2] / ph[:, 2:] - dst, axis=1)
    return res.reshape(nr, nc)


def _grid_smoothness_ok(uv_grid, constructed=None, win=5):
    """Strict post-refinement lattice validity, applied after subpixel
    refinement when the ordering ran on integer NMS peaks. Two tests:

    1. Smoothness (see smooth_enough in order_grid_points): max second
       difference along each axis under max(0.15 * pitch, 0.5 * win) px.
    2. Homography-outlier: fit the best homography canonical-grid -> uv and
       reject grids whose worst corner deviates far beyond the grid's own
       fit quality (max residual > max(4 x median, 1.2 px)). Lens
       distortion curves the whole grid coherently (median and max grow
       together, the relative bound holds); a clutter-substituted or
       mis-filled corner is a lone outlier (measured: bad corners sit at
       2-3 px residual vs <=0.6 px for genuine grids on hard frames).

    ``win`` is the subpixel-refinement window the grid was refined with.
    Refinement jitter grows with the blur scale the window was matched to
    (measured ~0.2-0.4 px at win 5 on sharp frames, 0.7-1.5 px at win
    11-17 on 12-24 px motion blur), and a second difference amplifies
    per-corner jitter up to 4x — the fine-scale constants veto genuinely
    correct coarse-rung grids (measured: a 12 px-blur board at win 17 with
    1.6 px true error shows 5.4 px max second difference vs the old fixed
    2.5-3.3 px limit). Both absolute floors scale linearly with ``win``,
    calibrated so win=5 reproduces the original constants exactly.

    ``constructed`` (optional (nr, nc) bool) marks homography-predicted
    cells (hole fills / repairs): they are consistent with the lattice by
    construction, so both criteria apply to MEASURED cells only — a
    predicted cell sitting ~1.5 px off the global fit (normal under lens
    distortion + the tight re-refine clamp) must not veto a window whose
    34 measured corners are clean.
    """
    con = None
    if constructed is not None:
        con = np.asarray(constructed, bool).reshape(uv_grid.shape[:2])
        if not con.any():
            con = None
    d0 = np.linalg.norm(np.diff(uv_grid, axis=0), axis=-1)
    d1 = np.linalg.norm(np.diff(uv_grid, axis=1), axis=-1)
    pitch = np.median(np.concatenate([d0.ravel(), d1.ravel()]))
    lim = max(0.15 * pitch, 0.5 * win, 2.5)
    for ax in (0, 1):
        d2d = np.linalg.norm(np.diff(uv_grid, n=2, axis=ax), axis=-1)
        if not d2d.size:
            continue
        if con is not None:
            # A second difference spans 3 consecutive cells; exempt spans
            # that touch a constructed cell.
            touches = con[:-2] | con[1:-1] | con[2:] if ax == 0 else (
                con[:, :-2] | con[:, 1:-1] | con[:, 2:]
            )
            d2d = np.where(touches, 0.0, d2d)
        if d2d.max() > lim:
            return False
    res = _lattice_residuals(uv_grid, con)
    floor = max(1.2, 0.24 * win)
    if con is None:
        return res.max() <= max(4.0 * np.median(res), floor)
    med = np.median(res[~con])
    if res[~con].max() > max(4.0 * med, floor):
        return False
    # Constructed cells: looser absolute bound (distortion bias of the
    # global fit + the tight re-refine clamp), but not exempt — a filled
    # cell whose refinement wandered off in noise must still be caught.
    return res[con].max() <= max(4.0 * med, 2.5, 0.5 * win)


def _settle_constructed(refined, predicted, constructed, tol=1.5):
    """Resolve constructed (hole-filled) cells after subpixel refinement.

    A hole whose corner merely fell out of the candidate top-K has a real
    saddle: refinement started at the homography prediction converges a
    sub-pixel distance away, and the refined position is the better
    measurement. An OCCLUDED hole has no saddle — refinement wanders up to
    ``max_drift`` toward whatever gradient structure the occluder offers.
    Keep the refined position only where it settled within ``tol`` px of
    the prediction; restore the homography prediction otherwise.
    """
    refined = np.asarray(refined, float)
    predicted = np.asarray(predicted, float)
    con = np.asarray(constructed, bool)
    if not con.any():
        return refined
    drift = np.linalg.norm(refined - predicted, axis=-1)
    restore = con & (drift > tol)
    return np.where(restore[..., None], predicted, refined)


def _repair_grid(uv_grid, max_outliers=3, constructed=None):
    """Re-predict lattice-inconsistent cells of a refined grid.

    The dominant hard-frame failure (measured on the detection bench's
    distorted/vignetted/cluttered views): the CORRECT window is found with
    34-35/35 true corners, but one cell — a dim corner whose subpixel
    refinement wandered, or a hole filled by the global homography whose
    prediction is biased a few px by lens distortion — trips
    ``_grid_smoothness_ok`` and vetoes the whole board.

    Repair: flag cells whose global-homography residual marks them as lone
    outliers (same criterion as the validity check), re-predict each from a
    LOCAL homography fitted to the nearest clean cells (a local fit tracks
    lens-distortion curvature to first order; the global fit does not), and
    return the repaired grid for tight re-refinement + re-validation by the
    caller. ``constructed`` marks cells that were already predictions
    (hole fills) — they are re-predicted too and excluded from every fit.
    Returns ``(repaired, bad_mask)`` where ``bad_mask`` includes both the
    newly flagged and the pre-constructed cells, or None when more than
    ``max_outliers`` cells are flagged (a genuinely broken window, not a
    repair candidate).
    """
    uv_grid = np.asarray(uv_grid, float)
    nr, nc = uv_grid.shape[:2]
    con = (
        np.zeros((nr, nc), bool)
        if constructed is None
        else np.asarray(constructed, bool).reshape(nr, nc)
    )
    res = _lattice_residuals(uv_grid, con if con.any() else None)
    meas = ~con
    med = np.median(res[meas]) if meas.any() else 0.0
    bad = (res > max(4.0 * med, 1.2)) & meas
    if not bad.any():
        # Validity failed on smoothness alone: treat the single
        # worst-residual measured cell as the outlier.
        worst = np.where(meas, res, -np.inf)
        bad = worst >= worst.max()
    n_bad = int(bad.sum())
    # ``max_outliers`` bounds NEW bad measured cells; cells that were
    # already constructed (hole fills) are re-predicted at no evidence
    # cost — they never carried a measurement. Bound the total so a
    # window still rests on a solid measured majority.
    if n_bad == 0 or n_bad > max_outliers or n_bad + int(con.sum()) > 5:
        return None
    bad = bad | con
    repaired = uv_grid.copy()
    ii, jj = np.mgrid[0:nr, 0:nc]
    good = ~bad
    if good.sum() < 8:  # too few clean cells for a stable local DLT
        return None
    for (bi, bj) in zip(*np.nonzero(bad)):
        # Nearest clean cells in lattice distance; argsort is truncated to
        # the good cells so inf-distance (bad) cells can never pad the fit
        # on small boards.
        dist = np.abs(ii - bi) + np.abs(jj - bj)
        dist = np.where(good, dist, np.inf)
        order = np.argsort(dist.ravel())[: min(10, int(good.sum()))]
        src = np.stack([ii.ravel()[order], jj.ravel()[order]], axis=-1)
        dst = uv_grid.reshape(-1, 2)[order]
        Hm = _dlt_homography_np(src, dst)
        v = Hm @ np.array([bi, bj, 1.0])
        repaired[bi, bj] = v[:2] / v[2]
    return repaired, bad


# ---------------------------------------------------------------------------
# Device stage 3: anchor disambiguation (two-sided board orientation)
# ---------------------------------------------------------------------------


@with_highest_precision
def extend_grid(uv_grid, extend_rows, extend_cols):
    """Homography-extrapolate a corner grid outward.

    ``uv_grid``: (rows, cols, 2) tensor -> (rows + 2*extend_rows, cols +
    2*extend_cols, 2).
    """
    rows = uv_grid.shape[0] + 2 * extend_rows
    cols = uv_grid.shape[1] + 2 * extend_cols
    ys, xs = np.mgrid[0:rows, 0:cols]
    xy_full = torch.as_tensor(
        np.stack([xs, ys], axis=-1), dtype=uv_grid.dtype, device=uv_grid.device
    )
    xy_inner = xy_full[extend_rows : rows - extend_rows, extend_cols : cols - extend_cols]
    H = fit_homography(xy_inner.reshape(-1, 2), uv_grid.reshape(-1, 2))
    return apply_homography(H, xy_full.reshape(-1, 2)).reshape(rows, cols, 2)


def _extend_grid_local(uv_grid, extend_rows, extend_cols, window=3):
    """Quadrant-local grid extension for the anchor probes, batched over
    leading dims: (..., R, C, 2) -> (..., R + 2*extend_rows, C +
    2*extend_cols, 2). Each quadrant is extrapolated from a homography fitted
    to the nearest ``window x window`` interior corners, which tracks lens
    distortion where the anchor probes live better than one global fit."""
    R, C = uv_grid.shape[-3], uv_grid.shape[-2]
    lead = uv_grid.shape[:-3]
    rows = R + 2 * extend_rows
    cols = C + 2 * extend_cols
    w = min(window, R, C)
    corner_windows = [(0, 0), (0, C - w), (R - w, C - w), (R - w, 0)]
    xy_full, src, q_idx = _extend_local_consts(
        R, C, extend_rows, extend_cols, w, uv_grid.dtype, uv_grid.device
    )
    dst = torch.stack(
        [
            uv_grid[..., i0 : i0 + w, j0 : j0 + w, :].reshape(*lead, w * w, 2)
            for (i0, j0) in corner_windows
        ],
        dim=-3,
    )  # (..., 4, w*w, 2)
    # The eigh DLT, by inverse iteration: no host sync in stage 1.
    H = fit_homography(src.expand(dst.shape), dst, method="inverse")
    exts = apply_homography(H, xy_full.reshape(-1, 2))  # (..., 4, rows*cols, 2)
    p_idx = torch.arange(rows * cols, device=uv_grid.device)
    return exts[..., q_idx, p_idx, :].reshape(*lead, rows, cols, 2)


@functools.cache
def _extend_local_consts(R, C, extend_rows, extend_cols, w, dtype, device):
    """The constant tensors of ``_extend_grid_local`` for one shape: the
    extended grid's lattice coordinates, the four corner windows' and each
    cell's quadrant. Cached per device, so that a call after the first
    copies nothing from the host (a blocking copy would synchronise the
    stream that streamed detection dispatches on)."""
    rows = R + 2 * extend_rows
    cols = C + 2 * extend_cols
    ys, xs = np.mgrid[0:rows, 0:cols]
    xy_full = torch.as_tensor(np.stack([xs, ys], axis=-1), dtype=dtype, device=device)
    corner_windows = [(0, 0), (0, C - w), (R - w, C - w), (R - w, 0)]
    src = torch.stack([
        xy_full[
            extend_rows + i0 : extend_rows + i0 + w, extend_cols + j0 : extend_cols + j0 + w
        ].reshape(-1, 2)
        for (i0, j0) in corner_windows
    ])  # (4, w*w, 2)
    top = ys < rows / 2
    left = xs < cols / 2
    quad = np.where(top & left, 0, np.where(top, 1, np.where(~left, 2, 3)))
    return xy_full, src, torch.as_tensor(quad.reshape(-1), device=device)


def _generate_anchor_template(size):
    """White square with a black circle in the top-left (numpy f64)."""
    ys, xs = np.mgrid[0:size, 0:size]
    circle = (ys - size // 4) ** 2 + (xs - size // 4) ** 2 <= (size // 4) ** 2
    return np.where(circle, 0.0, 255.0)


def _anchor_source_quads(ext):
    """The 4 candidate anchor-region quads (image coords) from the extended
    grid (..., R, C, 2) -> (..., 4, 4, 2)."""
    e = ext
    return torch.stack(
        [
            torch.stack([e[..., 2, 0, :], e[..., 0, 0, :], e[..., 0, 2, :], e[..., 2, 2, :]], -2),
            torch.stack([e[..., 0, -3, :], e[..., 0, -1, :], e[..., 2, -1, :], e[..., 2, -3, :]], -2),
            torch.stack([e[..., -3, -1, :], e[..., -1, -1, :], e[..., -1, -3, :], e[..., -3, -3, :]], -2),
            torch.stack([e[..., -1, 2, :], e[..., -1, 0, :], e[..., -3, 0, :], e[..., -3, 2, :]], -2),
        ],
        dim=-3,
    )


@functools.cache
def _detrend_np(s):
    """(template, X, pinv(X)) in numpy f64 for s x s regions."""
    ys, xs = np.mgrid[0:s, 0:s].astype(np.float64)
    X = np.stack([np.ones(s * s), xs.ravel(), ys.ravel()], axis=1)
    return _generate_anchor_template(s), X, np.linalg.pinv(X)


@functools.cache
def _anchor_consts(s, dtype, device):
    """(X, pinv(X), template) on ``device``, and the target quad of s x s
    regions; cached per device (see ``_extend_local_consts``)."""
    template, X, P = _detrend_np(s)
    target = [[0.0, s], [0.0, 0.0], [s, 0.0], [s, s]]
    return tuple(
        torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)
        for a in (X, P, template, target)
    )


def _anchor_detrend_basis(s, dtype, device):
    """Linear-ramp detrend projector + detrended template for s x s regions:
    removing the best-fit ramp before correlating makes the anchor score
    invariant to lighting gradients across the region."""
    Xt, Pt, template, _ = _anchor_consts(s, dtype, device)

    def detrend(v):
        return v - (v @ Pt.T) @ Xt.T  # batched over leading dims

    t = detrend(template.reshape(1, -1))[0]
    return detrend, t, torch.sqrt((t**2).sum())


_ANCHOR_PATCH = 64  # patch side the anchor regions are sampled from


def _anchor_match_scores_impl(image, ext, template_size=40):
    """Pearson correlation of the 4 candidate anchor regions vs the template,
    batched over frames: image (B, H, W) in [0, 255], ext (B, R, C, 2) from
    ``_extend_grid_local(grid, 3, 1)`` -> (B, 4).

    Each region is sampled at the s x s template grid pushed through the
    region's homography, bilinearly, from the image decimated by the
    smallest level in 1..4 whose 64-pixel patch holds the quad (the JAX
    package's patch pyramid; the four taps are gathered from the image
    directly, at the patch's stride), with zeros outside the patch.
    """
    s = template_size
    dtype, dev = image.dtype, image.device
    B, Him, Wim = image.shape
    span = min(4 * _ANCHOR_PATCH, Him, Wim)
    PS = min(_ANCHOR_PATCH, span)
    n_levels = max(span // PS, 1)

    target = _anchor_consts(s, dtype, dev)[3]
    all_source = _anchor_source_quads(ext)  # (B, 4, 4, 2)
    detrend, t, t_norm = _anchor_detrend_basis(s, dtype, dev)

    M = fit_homography(all_source, target.expand(all_source.shape), method="solve")
    gy, gx = torch.meshgrid(
        torch.arange(s, dtype=dtype, device=dev),
        torch.arange(s, dtype=dtype, device=dev),
        indexing="ij",
    )
    grid = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    src_xy = apply_homography(inv3x3(M), grid)  # (B, 4, s*s, 2)

    lo = all_source.amin(-2)  # (B, 4, 2)
    hi = all_source.amax(-2)
    extent = (hi - lo).amax(-1)
    level = torch.full(extent.shape, n_levels, dtype=torch.int64, device=dev)
    for lv in range(n_levels, 0, -1):
        level = torch.where(extent <= lv * (PS - 2), lv, level)
    sz = PS * level
    oy = torch.minimum((_f2i(torch.floor(lo[..., 1])) - 1).clamp(min=0), Him - sz)
    ox = torch.minimum((_f2i(torch.floor(lo[..., 0])) - 1).clamp(min=0), Wim - sz)
    lvf = level[..., None].to(dtype)
    rel_x = (src_xy[..., 0] - ox[..., None].to(dtype)) / lvf
    rel_y = (src_xy[..., 1] - oy[..., None].to(dtype)) / lvf

    x0 = torch.floor(rel_x)
    y0 = torch.floor(rel_y)
    fx, fy = rel_x - x0, rel_y - y0
    xi, yi = _f2i(x0), _f2i(y0)
    valid = (xi >= 0) & (xi < PS - 1) & (yi >= 0) & (yi < PS - 1)
    xi = xi.clamp(0, PS - 2)
    yi = yi.clamp(0, PS - 2)
    lvl = level[..., None]
    r0 = oy[..., None] + lvl * yi
    c0 = ox[..., None] + lvl * xi
    flat = image.reshape(B, -1)

    def at(r, c):
        return flat.gather(1, (r * Wim + c).reshape(B, -1)).reshape(r.shape)

    row0 = (1 - fy) * at(r0, c0) + fy * at(r0 + lvl, c0)
    row1 = (1 - fy) * at(r0, c0 + lvl) + fy * at(r0 + lvl, c0 + lvl)
    vals = torch.where(valid, row0 * (1 - fx) + row1 * fx, 0.0)  # (B, 4, s*s)

    r = detrend(vals)
    denom = torch.sqrt((r**2).sum(-1)) * t_norm
    return torch.where(denom > 1e-8, (r * t).sum(-1) / denom, 0.0)


@with_highest_precision
def _batched_anchor_scores(gray_b, grids_b, template_size=40):
    """(B, H, W) grays + (B, cols, rows, 2) grids -> (B, 4) anchor scores."""
    exts = _extend_grid_local(grids_b, 3, 1)
    return _anchor_match_scores_impl(gray_b, exts, template_size)


@with_highest_precision
def _normalize_local(gray_b, sigma=20.0):
    """Local contrast normalization: (g - mu_local) / (sd_local + eps),
    rescaled to [0, 255] (the working equivalent of the reference's
    ``normalize_image`` flag: flattens quadratic vignetting that the
    per-region linear detrend cannot remove)."""
    k = _gaussian_kernel1d(sigma, int(2.5 * sigma), gray_b.dtype, gray_b.device)
    mu = _conv2d_separable(gray_b, k)
    var = _conv2d_separable(gray_b * gray_b, k) - mu * mu
    sd = torch.sqrt(torch.clamp(var, min=0.0))
    eps = 0.05 * sd.mean(dim=(-2, -1), keepdim=True)
    out = (gray_b - mu) / (sd + eps)
    lo = out.amin(dim=(-2, -1), keepdim=True)
    hi = out.amax(dim=(-2, -1), keepdim=True)
    return (out - lo) / torch.clamp(hi - lo, min=1e-6) * 255.0


def _anchor_scores_normalized_at(gray_all, idx, grids, template_size):
    """Anchor scores over frames ``idx`` on locally NORMALIZED grays."""
    return _batched_anchor_scores(_normalize_local(gray_all[idx]), grids, template_size)


def _gray_from_u8(frames):
    """uint8 (B, H, W) or (B, H, W, 3) frames -> float32 grayscale batch."""
    x = frames.to(torch.float32)
    if frames.ndim == 4:
        # BGR weights (reference uses cv2.COLOR_BGR2GRAY).
        x = 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]
    return x


@with_highest_precision
def reorder_chessboard_corners(image, uvs, board_shape, template_size=40, device=None):
    """Orient the corner grid by the anchor dot.

    Returns (reordered uvs (N, 2), sorted match_scores (4,), vis_info), all
    numpy; ``device=None`` runs on the CUDA device.
    """
    img = _to_gray_f(image, _resolve_device(device))
    uv_grid = np.asarray(uvs).reshape(board_shape[1], board_shape[0], 2)
    ext = _extend_grid_local(torch.as_tensor(uv_grid, dtype=img.dtype, device=img.device), 3, 1)
    match_scores = _anchor_match_scores_impl(img[None], ext[None], template_size)[0]
    match_scores = match_scores.cpu().numpy()
    best = int(np.argmax(match_scores))
    if best in (2, 3):  # best match on the bottom row -> flip rows
        uv_grid = uv_grid[::-1, :]
    if best in (1, 2):  # best match on the right column -> flip cols
        uv_grid = uv_grid[:, ::-1]
    sorted_scores = np.sort(match_scores)[::-1]
    return uv_grid.reshape(-1, 2), sorted_scores, (ext.cpu().numpy(), match_scores)


# ---------------------------------------------------------------------------
# Batch pipeline
# ---------------------------------------------------------------------------


def _to_gray_f(image, device):
    """uint8 (H, W) or (H, W, 3) -> float32 grayscale tensor (the BGR
    weighting in f64 numpy, as the JAX package)."""
    img = np.asarray(image)
    if img.ndim == 3:
        img = 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
    return torch.as_tensor(img, dtype=torch.float32, device=device)


def _refine_and_score_impl(gray_b, grids, template_size, win_size, max_drift):
    """Subpixel-refine ordered grids (B, cols, rows, 2) and score their four
    anchor-orientation hypotheses."""
    B, gc, gr, _ = grids.shape
    flat = grids.reshape(B, gc * gr, 2).to(gray_b.dtype)
    refined = refine_corners_subpix(gray_b / 255.0, flat, win_size=win_size, max_drift=max_drift)
    grids_r = refined.reshape(B, gc, gr, 2)
    return grids_r, _batched_anchor_scores(gray_b, grids_r, template_size)


def _stage1_impl(gray_b, max_candidates, nms_radius, rows, cols, template_size, win_size):
    """Device stage 1: candidates (one corner-kernel launch) + device lattice
    ordering + refinement + anchor scores for every frame's window."""
    xy, score = find_corner_candidates(
        gray_b / 255.0, max_candidates=max_candidates, nms_radius=nms_radius
    )
    grids, ok = _order_grids_device(xy, score, rows, cols, min_candidate_sep=float(nms_radius + 1))
    grids_r, scores4 = _refine_and_score_impl(gray_b, grids, template_size, win_size, 3.0)
    return xy, score, grids_r, scores4, ok


def _coarse_retry_impl(
    gray_all, idx, max_candidates, nms_radius, rows, cols, template_size, win_size, sigma,
):
    """Coarse-scale retry over frames ``idx``: candidates at a LARGER
    response sigma (motion blur / defocus flattens det(Hessian) at the
    default 1.5; the saddle survives at the blur's own scale), device
    lattice ordering with a sigma-scaled position tolerance, then
    refinement + anchor scores on the original grays."""
    g = gray_all[idx]
    xy, score = find_corner_candidates(
        g / 255.0, max_candidates=max_candidates, nms_radius=nms_radius, sigma=sigma
    )
    grids, ok = _order_grids_device(
        xy, score, rows, cols, position_jitter=0.5 * float(sigma),
        min_candidate_sep=float(nms_radius + 1),
    )
    grids_r, scores4 = _refine_and_score_impl(g, grids, template_size, win_size, 3.0)
    return xy, score, grids_r, scores4, ok


def _subpix_win(subpix_winSize):
    """Normalize the reference's (w, h) winSize tuple to a scalar half-size
    (the refinement window is square: the larger half-size is used)."""
    if subpix_winSize is None:
        return 5
    try:
        return max(int(v) for v in subpix_winSize)
    except TypeError:
        return int(subpix_winSize)


def detect_chessboard(
    image,
    *,
    board_shape=(7, 10),
    subpix_winSize=(5, 5),
    scale_factor=1,
    adaptive_threshold=True,
    normalize_image=True,
    reorder=True,
    match_score_min_diff=0.2,
    max_candidates=160,
    nms_radius=4,
    device=None,
):
    """Detect and order chessboard corners in one image. Returns ``(uvs
    (N, 2), match_scores (4,))`` when ``reorder=True`` (None if no board or
    an ambiguous anchor), else ``uvs`` or None. ``adaptive_threshold`` is a
    no-op parity flag (the saddle response is invariant to the lighting
    fields it exists for).

    ``scale_factor == 1`` is the batch pipeline at B = 1. Otherwise the
    candidates come from the gray resized by ``scale_factor`` (bilinear,
    antialiased when it shrinks, as ``jax.image.resize``), are ordered into
    up to ``_N_WINDOW_HYPOTHESES`` windows (with the occlusion escalation's
    hole budget when none is found), and each window is refined at full
    resolution, validated and anchor-scored; then the repair pass and the
    normalized-anchor rescue, as in the JAX package."""
    del adaptive_threshold  # parity arg; the response is offset invariant
    if scale_factor == 1:
        return detect_chessboard_batch(
            [image],
            board_shape=board_shape,
            reorder=reorder,
            match_score_min_diff=match_score_min_diff,
            max_candidates=max_candidates,
            nms_radius=nms_radius,
            subpix_winSize=subpix_winSize,
            normalize_image=normalize_image,
            device=device,
        ).get(0)
    return _detect_scaled(
        image, board_shape, _subpix_win(subpix_winSize), scale_factor, normalize_image,
        reorder, match_score_min_diff, max_candidates, nms_radius, _resolve_device(device),
    )


@functools.cache
def _resize_weights(n_in, n_out):
    """(n_in, n_out) f32 weights of ``jax.image.resize``'s "bilinear" along
    one axis: the triangle kernel at the output samples' centres, widened by
    1 / scale when shrinking (antialiasing), normalized per output sample,
    and zero for samples outside the input; computed in f64."""
    inv = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


@with_highest_precision
def _resize_bilinear(gray, shape):
    """``jax.image.resize(gray, shape, "bilinear")`` for one (H, W) gray:
    the separable weights applied as two f32 products."""
    H, W = gray.shape
    wh = torch.as_tensor(_resize_weights(H, shape[0]), device=gray.device)
    ww = torch.as_tensor(_resize_weights(W, shape[1]), device=gray.device)
    return wh.T @ gray @ ww


@with_highest_precision
def _detect_scaled(image, board_shape, win_size, scale_factor, normalize_image, reorder,
                   match_score_min_diff, max_candidates, nms_radius, dev):
    """``detect_chessboard`` for ``scale_factor != 1`` (the JAX package's
    single-frame path): detection resolution for the candidates, full
    resolution for everything after them."""
    gray = _to_gray_f(image, dev)
    h, w = gray.shape
    gray_det = _resize_bilinear(
        gray, (int(round(h * scale_factor)), int(round(w * scale_factor))))
    xy, score = find_corner_candidates(
        gray_det[None] / 255.0, max_candidates=max_candidates, nms_radius=nms_radius)
    cand = xy[0].cpu().numpy() / scale_factor
    sc = score[0].cpu().numpy()
    order = functools.partial(
        order_grid_points, cand, sc, board_shape, refined=False,
        position_jitter=0.5 / scale_factor, n_windows=_N_WINDOW_HYPOTHESES,
        return_masks=True,
    )
    wins = order()
    esc_budget = _escalated_hole_budget(board_shape[0] * board_shape[1])
    if not wins and esc_budget > _HOLE_TOLERANCE:
        wins = order(max_holes=esc_budget)  # the occlusion escalation
    grid_shape = (board_shape[1], board_shape[0], 2)

    def refine(uvs, max_drift=3.0):
        pts = torch.as_tensor(np.asarray(uvs)[None], dtype=torch.float32, device=dev)
        return refine_corners_subpix(gray[None] / 255.0, pts, win_size=win_size,
                                     max_drift=max_drift)[0].cpu().numpy()

    def consider(uvs, cmask, best):
        """Validate and anchor-score one refined window: ("done", uvs) when
        ``reorder=False`` accepts it, else the better of ``best`` and
        (margin, reordered uvs, sorted scores, uvs)."""
        if not _grid_smoothness_ok(uvs.reshape(grid_shape), cmask, win=win_size):
            return best
        if not reorder:
            return ("done", uvs)
        uvs_r, match_scores, _ = reorder_chessboard_corners(image, uvs, board_shape, device=dev)
        margin = match_scores[0] - match_scores[1]
        if best is None or margin > best[0]:
            return (margin, uvs_r, match_scores, uvs)
        return best

    best = None
    refined_wins = []
    for uvs0, cmask in wins:
        uvs = _settle_constructed(refine(uvs0), np.asarray(uvs0, float), cmask)
        refined_wins.append((uvs, cmask))
        best = consider(uvs, cmask, best)
        if best is not None and best[0] == "done":
            return best[1]
    if best is None or best[0] < match_score_min_diff:
        # The repair pass: re-predict lone outlier cells, re-refine tightly.
        for uvs, cmask in refined_wins:
            rep = _repair_grid(uvs.reshape(grid_shape), constructed=cmask)
            if rep is None:
                continue
            rep_uvs, rep_mask = rep
            best = consider(refine(rep_uvs.reshape(-1, 2), max_drift=1.0),
                            rep_mask.reshape(-1), best)
            if best is not None and best[0] == "done":
                return best[1]
    if best is None or not reorder:
        return None
    margin, uvs_r, match_scores, uvs_raw = best
    if margin >= match_score_min_diff:
        return uvs_r, match_scores
    # The normalized-anchor rescue for a plausible margin.
    if normalize_image and margin >= 0.4 * match_score_min_diff:
        g_norm = _normalize_local(gray[None])[0].cpu().numpy()
        uvs_n, scores_n, _ = reorder_chessboard_corners(g_norm, uvs_raw, board_shape, device=dev)
        if scores_n[0] - scores_n[1] >= match_score_min_diff:
            return uvs_n, scores_n
    return None


@with_highest_precision
def detect_chessboard_batch(
    images,
    *,
    board_shape=(7, 10),
    reorder=True,
    match_score_min_diff=0.2,
    max_candidates=160,
    nms_radius=4,
    template_size=40,
    scale_factor=1,
    subpix_winSize=(5, 5),
    adaptive_threshold=True,
    normalize_image=True,
    coarse_downscale=1,
    device=None,
    **unsupported,
):
    """Detect over a batch of uint8 frames (B, H, W) or (B, H, W, 3).

    Stage 1 runs on the device for the whole batch: grayscale, one launch of
    the fused corner kernel, top-K, device lattice ordering, refinement and
    anchor scores. Frames it certifies are decided on the host at once;
    the rest take the host lattice ordering, the repair pass, the coarse
    sigma ladder (3.5, 6, 9; one more kernel launch per rung that still has
    failed frames), the occlusion escalation and the normalized-anchor
    rescue, as in the JAX package.

    ``coarse_downscale = f > 1`` runs stage 1 and the host decisions on
    host box-decimated frames (1/f^2 of the bytes uploaded), re-refines every
    accepted corner at full resolution on uploaded patches, and sends the
    frames it loses, or whose promoted grid fails the full-resolution
    lattice gate, through this full-resolution path. ``scale_factor != 1``
    runs ``detect_chessboard`` frame by frame.

    Returns ``{frame_index: (uvs (N, 2), sorted scores (4,))}`` (``uvs``
    alone when ``reorder=False``), numpy. ``device=None`` runs on the CUDA
    device and raises without one; unknown keyword arguments raise
    ``TypeError``.
    """
    del adaptive_threshold  # parity arg; the response is offset invariant
    if unsupported:
        raise TypeError(f"unexpected keyword arguments: {sorted(unsupported)}")
    dev = _resolve_device(device)
    win_size = _subpix_win(subpix_winSize)
    B = len(images)
    if scale_factor != 1:
        out = {}
        for i, img in enumerate(images):
            det = detect_chessboard(
                img, board_shape=board_shape, reorder=reorder,
                match_score_min_diff=match_score_min_diff, max_candidates=max_candidates,
                nms_radius=nms_radius, scale_factor=scale_factor,
                subpix_winSize=subpix_winSize, normalize_image=normalize_image, device=dev,
            )
            if det is not None:
                out[i] = det
        return out
    if B == 0:
        return {}
    opts = _BatchOptions(board_shape, reorder, match_score_min_diff, max_candidates,
                         nms_radius, template_size, win_size, normalize_image,
                         coarse_downscale, dev)
    return opts.finish(opts.dispatch(images))


@dataclasses.dataclass(frozen=True)
class _BatchOptions:
    """The options of one batch detection, and its two halves: ``dispatch``
    (upload and device stage 1; reads nothing back) and ``finish`` (the host
    decisions). ``coarse_downscale`` > 1 is the low-band path, at
    ``f = int(coarse_downscale)``."""

    board_shape: tuple
    reorder: bool
    match_score_min_diff: float
    max_candidates: int
    nms_radius: int
    template_size: int
    win_size: int
    normalize_image: bool
    coarse_downscale: float
    dev: torch.device

    @property
    def lowband(self):
        return bool(self.coarse_downscale and self.coarse_downscale > 1)

    @property
    def f(self):
        return int(self.coarse_downscale) if self.lowband else 1

    def dispatch(self, images, stage=None):
        if self.lowband:
            return _lowband_dispatch(images, self, stage)
        return _batch_dispatch(
            images, self.max_candidates, self.nms_radius, self.win_size, self.board_shape,
            self.template_size, self.dev, stage,
        ), len(images)

    def finish(self, state):
        if self.lowband:
            return _lowband_finish(state, self)
        stage1, B = state
        return _batch_finish(
            stage1, B, self.board_shape, self.reorder, self.match_score_min_diff,
            self.template_size, self.win_size, normalize_image=self.normalize_image,
            max_candidates=self.max_candidates, nms_radius=self.nms_radius,
        )


def detect_chessboard_batches(
    batches,
    *,
    board_shape=(7, 10),
    reorder=True,
    match_score_min_diff=0.2,
    max_candidates=160,
    nms_radius=4,
    template_size=40,
    scale_factor=1,
    subpix_winSize=(5, 5),
    adaptive_threshold=True,
    normalize_image=True,
    coarse_downscale=1,
    device=None,
    **unsupported,
):
    """``detect_chessboard_batch`` over an iterable of frame batches, with
    one batch of lookahead.

    Yields one ``{batch_local_index: detection}`` dict per input batch, in
    order (``{}`` for an empty batch), equal to what
    ``detect_chessboard_batch`` returns for that batch with the same
    options. Batch k + 1 is dispatched (uploaded and its device stage 1
    queued, with nothing read back) before batch k's host half runs, so on
    the card its copy and device work can run while batch k's host work
    does. Each batch in flight owns a
    CUDA stream and a pinned host buffer: the frames are staged into the
    buffer and copied with ``non_blocking=True`` on the batch's stream,
    which runs its stage 1 and, later, its host half's device calls, so no
    tensor crosses streams. A buffer is refilled only after the event
    recorded behind its last copy has completed. ``scale_factor != 1``
    (the per-frame path) has nothing to overlap and runs batch by batch.
    """
    del adaptive_threshold  # parity arg; the response is offset invariant
    if unsupported:
        raise TypeError(f"unexpected keyword arguments: {sorted(unsupported)}")
    dev = _resolve_device(device)
    if scale_factor != 1:
        for images in batches:
            yield detect_chessboard_batch(
                images, board_shape=board_shape, reorder=reorder,
                match_score_min_diff=match_score_min_diff, max_candidates=max_candidates,
                nms_radius=nms_radius, template_size=template_size,
                scale_factor=scale_factor, subpix_winSize=subpix_winSize,
                normalize_image=normalize_image, device=dev,
            )
        return
    opts = _BatchOptions(board_shape, reorder, match_score_min_diff, max_candidates,
                         nms_radius, template_size, _subpix_win(subpix_winSize),
                         normalize_image, coarse_downscale, dev)
    on_card = dev.type == "cuda"
    # Two slots: the batch being finished and the one dispatched ahead.
    slots = [(torch.cuda.Stream(dev) if on_card else None,
              _PinnedStage() if on_card else None) for _ in range(2)]

    @with_highest_precision
    def dispatch(images, stream, stage):
        with _on(stream), metrics.span("detect_chessboard_batches.dispatch"):
            return opts.dispatch(images, stage), stream

    @with_highest_precision
    def finish(pending):
        state, stream = pending
        with _on(stream), metrics.span("detect_chessboard_batches.finish"):
            return opts.finish(state)

    # A result is made under its batch's stream and yielded outside it, so
    # the caller's code between two results runs on its own stream.
    pending = None  # (state, stream) of the batch dispatched before this one
    for k, images in enumerate(batches):
        cur = dispatch(images, *slots[k % 2]) if len(images) else None
        if pending is not None:
            yield finish(pending)
        pending = cur
        if cur is None:
            yield {}
    if pending is not None:
        yield finish(pending)


def _on(stream):
    """``torch.cuda.stream(stream)``, or nothing for the CPU (``None``)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


class _PinnedStage:
    """A pinned host buffer that one batch's frames are staged into for an
    asynchronous copy to the card, and the event recorded after that copy."""

    def __init__(self):
        self.buf = None
        self.copied = None

    def upload(self, frames, dev):
        """Copy ``frames`` (a list of (H, W[, 3]) arrays, or one array) to
        ``dev`` on the current stream without blocking the host."""
        first = np.asarray(frames[0])
        shape = (len(frames),) + first.shape
        dtype = torch.from_numpy(first.reshape(-1)[:0]).dtype
        if self.copied is not None:
            self.copied.synchronize()  # the buffer's last copy has finished
        if self.buf is None or tuple(self.buf.shape) != shape or self.buf.dtype != dtype:
            self.buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        host = self.buf.numpy()
        if isinstance(frames, np.ndarray):
            np.copyto(host, frames)
        else:
            np.stack([np.asarray(im) for im in frames], out=host)
        out = self.buf.to(dev, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()
        metrics.count("detect.upload_bytes", host.nbytes)
        return out


def _upload(arr, dev):
    """``arr`` (numpy) as a tensor on ``dev``. The counter
    ``detect.upload_bytes`` counts the bytes of the frames and patches that
    detection copies to a card."""
    if dev.type != "cpu":
        metrics.count("detect.upload_bytes", arr.nbytes)
    return torch.as_tensor(arr, device=dev)


def _batch_dispatch(images, max_candidates, nms_radius, win_size, board_shape, template_size, dev,
                    stage=None):
    """Upload the uint8 frames and queue device stage 1; returns (gray, xy,
    score, grids, scores4, ok) as device tensors and reads nothing back.
    With ``stage`` (a ``_PinnedStage``) the copy goes through its pinned
    buffer without blocking; without, ``images`` are stacked and copied
    from pageable memory."""
    if stage is None:
        frames = _upload(np.stack([np.asarray(im) for im in images]), dev)
    else:
        frames = stage.upload(images, dev)
    gray = _gray_from_u8(frames)
    rows, cols = board_shape
    return (gray,) + _stage1_impl(
        gray, max_candidates, nms_radius, rows, cols, template_size, win_size
    )


# ---------------------------------------------------------------------------
# Low-band batch path: stage 1 and the host decisions on host-decimated
# frames, full-resolution accuracy from per-corner patches uploaded alone.
# ---------------------------------------------------------------------------


def _decimate_u8(frames, f):
    """Box-mean decimate uint8 frames (B, H, W[, 3]) by the integer ``f``:
    the rounded mean (sum + f^2 // 2) // f^2 of each f x f block, cropping
    the ragged edge. Low-res pixel j covers full-res pixels f j .. f j + f - 1,
    so a low-res coordinate x maps back to f x + (f - 1) / 2.

    The JAX package's integers, summed rows first (contiguous slices), then
    columns, in uint16 where the block sum fits (f <= 15) and uint32 beyond:
    uint16 overflows at f >= 16."""
    B, H, W = frames.shape[:3]
    Hc, Wc = (H // f) * f, (W // f) * f
    acc_t = np.uint16 if f * f * 255 + f * f // 2 <= np.iinfo(np.uint16).max else np.uint32
    x = frames[:, :Hc, :Wc].reshape((B, Hc // f, f, Wc) + frames.shape[3:])
    rows = x[:, :, 0].astype(acc_t)
    for a in range(1, f):
        rows += x[:, :, a]
    rows = rows.reshape((B, Hc // f, Wc // f, f) + frames.shape[3:])
    out = rows[:, :, :, 0].copy()
    for b in range(1, f):
        out += rows[:, :, :, b]
    out += f * f // 2
    out //= f * f
    return out.astype(np.uint8)


def _refine_u8_patches(patches, q0, win_size, max_drift=3.0):
    """Subpixel-refine corners on uint8 patches (M, S2, S2[, 3]) with
    S2 = 2 (win_size + ceil(max_drift) + 1) + 3 (a one-pixel margin for the
    central differences); ``q0`` (M, 2) is the start in the gradient
    patch's frame (patch pixel (1, 1) is its (0, 0)). Returns (M, 2) in the
    same frame."""
    g = _gray_from_u8(patches) / 255.0
    gx = 0.5 * (g[:, 1:-1, 2:] - g[:, 1:-1, :-2])
    gy = 0.5 * (g[:, 2:, 1:-1] - g[:, :-2, 1:-1])
    return _subpix_refine_patches(gx, gy, q0, win_size, max_drift=max_drift)


def _refine_fullres_group(frames, pts_full, win_size, dev, max_drift=3.0):
    """Full-resolution refinement of ``pts_full`` (n, K, 2): the S2 x S2
    uint8 patch around each point is cut on the host, the patches alone are
    uploaded (~1/20 of the frames' bytes) and refined on ``dev``; returns
    (n, K, 2) f64.

    Row a of ``pts_full`` is cut from ``frames[a]``, as the JAX package
    does: its caller passes the group's points and the batch's frames, so a
    group that is not the batch's leading frames in order is refined on
    other frames' pixels (ROADMAP, Queue 3)."""
    n, K = pts_full.shape[:2]
    R = win_size + int(np.ceil(max_drift)) + 1
    S2 = 2 * R + 3
    H, W = frames.shape[1:3]
    cxy = np.rint(pts_full).astype(np.int64)
    ox = np.clip(cxy[..., 0] - (R + 1), 0, W - S2)
    oy = np.clip(cxy[..., 1] - (R + 1), 0, H - S2)
    ar = np.arange(S2)
    patches = frames[np.arange(n)[:, None, None, None],
                     (oy[..., None] + ar)[..., :, None],
                     (ox[..., None] + ar)[..., None, :]]  # (n, K, S2, S2[, 3])
    origin = np.stack([ox + 1, oy + 1], axis=-1).astype(np.float64)
    q0 = (pts_full - origin).reshape(n * K, 2)
    refined = _refine_u8_patches(
        _upload(patches.reshape((n * K,) + patches.shape[2:]), dev),
        torch.as_tensor(q0, dtype=torch.float32, device=dev), win_size, max_drift=max_drift,
    )
    return refined.cpu().numpy().astype(np.float64).reshape(n, K, 2) + origin


def _lowband_params(opts):
    """(nms, template size, window) at 1/f resolution."""
    f = opts.f
    return (max(2, int(round(opts.nms_radius / f))), max(16, int(round(opts.template_size / f))),
            max(3, int(round(opts.win_size / f))))


def _lowband_dispatch(images, opts, stage=None):
    """Decimate on the host, upload the small frames, queue stage 1 at 1/f
    resolution. Returns (stage-1 tensors, the full-res host frames, images)."""
    frames = np.stack([np.asarray(im) for im in images])
    low = _decimate_u8(frames, opts.f)
    nms_low, tpl_low, win_low = _lowband_params(opts)
    stage1 = _batch_dispatch(low, opts.max_candidates, nms_low, win_low, opts.board_shape,
                             tpl_low, opts.dev, stage)
    return stage1, frames, images


def _lowband_finish(state, opts):
    """Low-res decisions, full-resolution patch re-refinement of every
    accepted corner, and the full-resolution batch path for lost frames."""
    stage1, frames, images = state
    B = len(images)
    nms_low, tpl_low, win_low = _lowband_params(opts)
    out_low, acc_win = _batch_finish(
        stage1, B, opts.board_shape, opts.reorder, opts.match_score_min_diff, tpl_low,
        win_low, normalize_image=opts.normalize_image, max_candidates=opts.max_candidates,
        nms_radius=nms_low, return_win=True,
    )
    out = _lowband_promote(frames, out_low, acc_win, opts, win_low)
    failed = [i for i in range(B) if i not in out]
    if failed:
        # The JAX package pads this batch to a power of two with repeats of
        # its first frame to reuse a TPU compile; decisions are per frame.
        sub = dataclasses.replace(opts, coarse_downscale=1)
        sub_out = sub.finish(sub.dispatch([images[i] for i in failed]))
        for j, i in enumerate(failed):
            if j in sub_out:
                out[i] = sub_out[j]
    return out


def _lowband_promote(frames, out_low, acc_win, opts, win_low):
    """Scale low-res detections to full resolution and patch-refine each
    corner, grouped by the refinement window of each frame's acceptance: a
    standard acceptance refines at the caller's window, a coarse-rung one at
    the rung's window times f (at most 17). A refined corner more than 3 px
    from its promoted position keeps the promoted one; a grid failing the
    full-resolution lattice gate is dropped (the caller escalates it)."""
    if not out_low:
        return {}
    f = opts.f
    cols, rows = opts.board_shape[1], opts.board_shape[0]
    groups = {}
    for i in out_low:
        w_low = acc_win.get(i, win_low)
        w_full = opts.win_size if w_low <= win_low else min(f * w_low, 17)
        groups.setdefault(w_full, []).append(i)
    out = {}
    for w_full, idxs in groups.items():
        pts_low = np.stack(
            [np.asarray(out_low[i][0] if opts.reorder else out_low[i]) for i in idxs])
        pts_full = pts_low * f + (f - 1) / 2.0
        refined = _refine_fullres_group(frames, pts_full, w_full, opts.dev)
        drift = np.linalg.norm(refined - pts_full, axis=-1, keepdims=True)
        refined = np.where(drift <= 3.0, refined, pts_full)
        for a, i in enumerate(idxs):
            if not _grid_smoothness_ok(refined[a].reshape(cols, rows, 2), win=w_full):
                continue
            out[i] = (refined[a], out_low[i][1]) if opts.reorder else refined[a]
    return out


# Window hypotheses per frame on the host path: on hard frames the true
# window often carries 1-2 holes and is outranked by shifted "complete"
# windows of weak boundary corners (measured at rank 4-6). They are
# evaluated lazily, so clean frames score only the first.
_N_WINDOW_HYPOTHESES = 6

# Coarse retry ladder for failed frames: (response sigma, subpixel window).
# Motion blur / defocus collapses the sigma=1.5 saddle response; the window
# must be scale-matched too, and the ordering tolerance scales with sigma.
_COARSE_SCALES = ((3.5, 11), (6.0, 17), (9.0, 21))


def _batch_finish(
    stage1, B, board_shape, reorder, match_score_min_diff, template_size,
    win_size=5, normalize_image=True, max_candidates=160, nms_radius=4,
    return_win=False,
):
    """Host half of the batch pipeline.

    Frames the device ordering certified are checked first (strict lattice
    check + anchor margin) and need no further device work. The rest are
    ordered on the host into up to ``_N_WINDOW_HYPOTHESES`` windows, which
    one device call refines and scores; per frame the hypothesis with the
    best anchor margin among those passing the strict post-refinement
    lattice check wins. Then, for frames still failing: the repair pass,
    the coarse sigma ladder, the occlusion escalation and the
    normalized-anchor rescue.

    With ``return_win`` it returns ``(out, acc_win)``: ``acc_win`` maps each
    accepted frame to the refinement window its acceptance used (the
    standard ``win_size``, or a coarse rung's), which the low-band promotion
    needs to pick its full-resolution window.
    """
    gray, xy_d, score_d, fast_uv_d, fast_sc4_d, fast_ok_d = stage1
    dev = gray.device

    NW = _N_WINDOW_HYPOTHESES
    cols, rows = board_shape[1], board_shape[0]

    _filler = (
        np.stack(np.mgrid[0:cols, 0:rows][::-1], axis=-1) + 32
    ).astype(np.float64)

    def score_at(frame_ixs, hyps_arr, max_drift=3.0, win=None):
        """One refine + anchor-score pass over the given frames' hypotheses
        (row j of ``hyps_arr`` belongs to frame ``frame_ixs[j]``)."""
        idx = torch.as_tensor(np.asarray(frame_ixs, np.int64), device=dev)
        grids_r, scores4 = _refine_and_score_impl(
            gray[idx],
            torch.as_tensor(np.asarray(hyps_arr), dtype=gray.dtype, device=dev),
            template_size,
            win_size if win is None else win,
            max_drift,
        )
        return grids_r.cpu().numpy(), scores4.cpu().numpy()

    def apply_anchor(g, ms):
        """Final detection value: grid flipped so the anchor sits at the
        origin corner, plus the sorted 4-anchor scores."""
        best = int(np.argmax(ms))
        if best in (2, 3):  # anchor on the bottom row -> flip rows
            g = g[::-1, :]
        if best in (1, 2):  # anchor on the right col -> flip cols
            g = g[:, ::-1]
        return (g.reshape(-1, 2), np.sort(ms)[::-1])

    near = {}  # frame -> (margin, raw grid, raw anchor scores): near-misses
    acc_win = {}  # frame -> refinement window its acceptance used

    def pick(i, grids_i, scores_i, n, out, con_i=None, win=None):
        """Best hypothesis for frame i: strict lattice check (measured
        cells only when ``con_i`` constructed masks are given; ``win`` is
        the refinement window the grids were refined with), then the anchor
        decision with the largest margin. True = accepted. Valid grids whose
        margin falls short are recorded in ``near`` for the rescue pass."""
        best_pick = None  # (margin, raw grid, raw scores)
        for h in range(n):
            g = grids_i[h]
            if not _grid_smoothness_ok(
                g, None if con_i is None else con_i[h],
                win=win_size if win is None else win,
            ):
                continue
            if not reorder:
                # No anchor decision requested: first valid window wins.
                out[int(i)] = g.reshape(-1, 2)
                acc_win[int(i)] = win_size if win is None else win
                return True
            ms = scores_i[h]
            ss = np.sort(ms)[::-1]
            margin = ss[0] - ss[1]
            if best_pick is None or margin > best_pick[0]:
                best_pick = (margin, g, ms)
        if best_pick is not None and best_pick[0] >= match_score_min_diff:
            out[int(i)] = apply_anchor(best_pick[1], best_pick[2])
            acc_win[int(i)] = win_size if win is None else win
            return True
        if best_pick is not None:
            cur = near.get(int(i))
            if cur is None or best_pick[0] > cur[0]:
                near[int(i)] = best_pick
        return False

    # Fast-path frames first: ordered, refined and anchor-scored in stage 1.
    with metrics.span("detect.finish.fast"):
        out = {}
        fast_ok = fast_ok_d.cpu().numpy()
        fast_uv = fast_uv_d.cpu().numpy()
        fast_sc4 = fast_sc4_d.cpu().numpy()
        fallback = []
        for i in range(B):
            if not (fast_ok[i] and pick(i, fast_uv[i][None], fast_sc4[i][None], 1, out)):
                fallback.append(i)

    # Host lattice ordering for the fallback frames only.
    with metrics.span("detect.finish.lattice"):
        hyp = np.broadcast_to(_filler, (B, NW, cols, rows, 2)).copy()
        con = np.zeros((B, NW, cols, rows), bool)  # constructed-cell masks
        n_hyp = np.zeros(B, np.int64)
        xy = score = None
        if fallback:
            xy = xy_d.cpu().numpy()
            score = score_d.cpu().numpy()
            for i in fallback:
                wins = order_grid_points(
                    xy[i], score[i], board_shape, refined=False, n_windows=NW,
                    return_masks=True,
                )
                for h, (uvs, mask) in enumerate(wins):
                    hyp[i, h] = np.asarray(uvs).reshape(cols, rows, 2)
                    con[i, h] = np.asarray(mask).reshape(cols, rows)
                n_hyp[i] = len(wins)

    # Lazy hypothesis evaluation: the top-ranked window first, the others
    # only for frames that reject it.
    with metrics.span("detect.finish.hypotheses"):
        fb = [i for i in range(B) if n_hyp[i] > 0]
        grids1 = {}  # frame -> (refined hyp-0 grid, scores)
        grids2 = {}  # frame -> (refined hyp-1.. grids, scores)
        if fb:
            g1, s1 = score_at(np.array(fb), hyp[np.array(fb), 0])
            retry = []
            for j, i in enumerate(fb):
                g1j = _settle_constructed(g1[j], hyp[i, 0], con[i, 0])
                grids1[i] = (g1j, s1[j])
                if (
                    not pick(i, g1j[None], s1[j][None], 1, out, con[i, 0:1])
                    and n_hyp[i] > 1
                ):
                    retry.append(i)
            if retry:
                ridx = np.repeat(np.array(retry), NW - 1)
                g2, s2 = score_at(
                    ridx, hyp[np.array(retry), 1:].reshape(-1, cols, rows, 2)
                )
                for j, i in enumerate(retry):
                    sl = slice(j * (NW - 1), (j + 1) * (NW - 1))
                    g2s = np.stack(
                        [
                            _settle_constructed(
                                g2[sl][h], hyp[i, 1 + h], con[i, 1 + h]
                            )
                            for h in range(NW - 1)
                        ]
                    )
                    grids2[i] = (g2s, s2[sl])
                    pick(i, g2s, s2[sl], int(n_hyp[i]) - 1, out, con[i, 1:])

    # Repair phase (failed frames only): re-predict lone outlier cells from
    # local homographies, tightly re-refine (max_drift=1.0) and re-score.
    with metrics.span("detect.finish.repair"):
        failed = [i for i in fb if i not in out]
        if failed:
            entries = []  # (frame index, repaired grid, constructed mask)
            for i in failed:
                cand = [(grids1[i][0], con[i, 0])]
                if i in grids2:
                    cand += [
                        (grids2[i][0][h], con[i, h + 1])
                        for h in range(int(n_hyp[i]) - 1)
                    ]
                for g, cmask in cand:
                    rep = _repair_grid(g, constructed=cmask)
                    if rep is not None:
                        entries.append((i,) + rep)
            if entries:
                idx = np.array([e[0] for e in entries])
                rep_grids = np.stack([e[1] for e in entries])
                rep_masks = np.stack([e[2] for e in entries])
                grids_r, scores_r = score_at(idx, rep_grids, max_drift=1.0)
                for i in failed:
                    rows_i = np.nonzero(idx == i)[0]
                    if len(rows_i):
                        pick(
                            i, grids_r[rows_i], scores_r[rows_i], len(rows_i),
                            out, rep_masks[rows_i],
                        )

    # Coarse-scale retry ladder (failed frames only): candidates + device
    # ordering at the blur's own scale, refinement and anchor scores on the
    # original grays with a scale-matched window.
    with metrics.span("detect.finish.coarse"):
        for c_sigma, c_win in _COARSE_SCALES:
            failed2 = [i for i in range(B) if i not in out]
            if not failed2:
                break
            metrics.count("detect.coarse.tried", len(failed2))
            n_out = len(out)
            _, _, gridc, s4c, okc = _coarse_retry_impl(
                gray, torch.as_tensor(failed2, device=dev), max_candidates,
                nms_radius, rows, cols, template_size, max(win_size, c_win), c_sigma,
            )
            okc = okc.cpu().numpy()
            if okc.any():
                gridc_h = gridc.cpu().numpy()
                s4c_h = s4c.cpu().numpy()
            for j, i in enumerate(failed2):
                if okc[j]:
                    pick(
                        i, gridc_h[j][None], s4c_h[j][None], 1, out,
                        win=max(win_size, c_win),
                    )
            metrics.count("detect.coarse.accepted", len(out) - n_out)

    # Occlusion escalation (after the coarse ladder): host ordering with a
    # relaxed hole budget; constructed cells settle back onto their
    # homography predictions where refinement found no saddle.
    with metrics.span("detect.finish.escalate"):
        esc_budget = _escalated_hole_budget(rows * cols)
        failed3 = [i for i in range(B) if i not in out]
        if failed3 and esc_budget > _HOLE_TOLERANCE:
            if xy is None:
                xy = xy_d.cpu().numpy()
                score = score_d.cpu().numpy()
            entries = []
            for i in failed3:
                wins = order_grid_points(
                    xy[i], score[i], board_shape, refined=False, n_windows=NW,
                    return_masks=True, max_holes=esc_budget,
                )
                for uvs, mask in wins:
                    entries.append(
                        (
                            i,
                            np.asarray(uvs).reshape(cols, rows, 2),
                            np.asarray(mask).reshape(cols, rows),
                        )
                    )
            if entries:
                idx = np.array([e[0] for e in entries])
                esc_grids = np.stack([e[1] for e in entries])
                esc_masks = np.stack([e[2] for e in entries])
                grids_e, scores_e = score_at(idx, esc_grids)
                for i in failed3:
                    rows_i = np.nonzero(idx == i)[0]
                    if len(rows_i):
                        g_set = np.stack(
                            [
                                _settle_constructed(
                                    grids_e[r], esc_grids[r], esc_masks[r]
                                )
                                for r in rows_i
                            ]
                        )
                        pick(
                            i, g_set, scores_e[rows_i], len(rows_i), out,
                            esc_masks[rows_i],
                        )

    # Normalized-anchor rescue (near-miss frames only): re-score the best
    # grid on locally normalized grays; a decisive margin accepts. Only
    # plausible margins (>= 0.4x the threshold) are retried.
    with metrics.span("detect.finish.rescue"):
        if reorder and normalize_image:
            resc = [
                i
                for i in range(B)
                if i not in out
                and i in near
                and near[i][0] >= 0.4 * match_score_min_diff
            ]
            if resc:
                grids_n = np.stack([near[i][1] for i in resc])
                scores_n = _anchor_scores_normalized_at(
                    gray,
                    torch.as_tensor(resc, device=dev),
                    torch.as_tensor(grids_n, dtype=gray.dtype, device=dev),
                    template_size,
                ).cpu().numpy()
                for j, i in enumerate(resc):
                    ms = scores_n[j]
                    ss = np.sort(ms)[::-1]
                    if ss[0] - ss[1] >= match_score_min_diff:
                        out[int(i)] = apply_anchor(near[i][1], ms)
                        acc_win[int(i)] = win_size
    return (out, acc_win) if return_win else out
