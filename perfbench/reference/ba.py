"""Plain reference for bundle adjustment: the cost that ``bundle_adjust``
minimises, its frame selection, and a Levenberg-Marquardt polish, in
plain PyTorch float64.

Written from the documented semantics (the upstream project's
``bundle_adjustment.py``: frames seen whole by two cameras or more, frames
whose worst per-camera mean error exceeds 5 x the median error dropped, a
seeded subsample to ``n_frames``, soft-L1 loss with ``f_scale`` 1) and the
camera model (pinhole, radial k1 and k2 on normalised coordinates). It
imports nothing of the program. Parameters: a camera is (fx, fy, cx, cy,
k1, k2, rotation vector, translation) world -> camera, a board pose
(rotation vector, translation) board -> world.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

F64 = torch.float64


def rotation(r):
    """Rotation vectors (..., 3) -> matrices (..., 3, 3) (Rodrigues), with
    finite derivatives at the zero rotation."""
    t2 = (r * r).sum(-1)
    small = t2 < 1e-12
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / (t * t))
    z = torch.zeros_like(r[..., 0])
    K = torch.stack([z, -r[..., 2], r[..., 1], r[..., 2], z, -r[..., 0],
                     -r[..., 1], r[..., 0], z], -1).reshape(*r.shape[:-1], 3, 3)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def predict(cam, pose, objp):
    """Pixels (C, F, N, 2) of board points ``objp`` (N, 3) at poses (F, 6)
    in cameras (C, 12)."""
    world = objp @ rotation(pose[:, :3]).mT + pose[:, None, 3:]  # (F, N, 3)
    pc = world[None] @ rotation(cam[:, 6:9])[:, None].mT + cam[:, None, None, 9:12]
    x, y = pc[..., 0] / pc[..., 2], pc[..., 1] / pc[..., 2]
    c = cam[:, None, None]
    r2 = x * x + y * y
    radial = 1.0 + c[..., 4] * r2 + c[..., 5] * r2 * r2
    return torch.stack([c[..., 0] * x * radial + c[..., 2], c[..., 1] * y * radial + c[..., 3]],
                       -1)


def camera_params(extrinsics, intrinsics):
    """(C, 12) numpy rows from 6-vector extrinsics and (K, dist) pairs."""
    return np.stack([np.concatenate([[K[0][0], K[1][1], K[0][2], K[1][2]],
                                     np.asarray(d, float).reshape(-1)[:2], np.asarray(e, float)])
                     for e, (K, d) in zip(extrinsics, intrinsics)])


class Problem:
    """Observations (C, F, N, 2) with NaN where unseen, on ``device``, in
    frame blocks of ``block`` frames."""

    def __init__(self, obs, objp, device, block=512):
        obs = np.asarray(obs, float)
        self.mask = torch.as_tensor(~np.isnan(obs).any(-1), device=device)
        self.obs = torch.as_tensor(np.nan_to_num(obs), dtype=F64, device=device)
        self.objp = torch.as_tensor(np.asarray(objp, float), dtype=F64, device=device)
        self.F = obs.shape[1]
        self.block = int(block)

    def blocks(self):
        for lo in range(0, self.F, self.block):
            yield slice(lo, min(lo + self.block, self.F))

    def residual(self, cam, pose, s):
        r = predict(cam, pose[s], self.objp) - self.obs[:, s]
        return torch.where(self.mask[:, s, :, None], r, 0.0)

    def cost(self, cam, pose):
        """0.5 * sum of soft-L1 rho(r^2) over the observed components."""
        total = torch.zeros((), dtype=F64, device=cam.device)
        for s in self.blocks():
            r = self.residual(cam, pose, s)
            total = total + torch.where(self.mask[:, s, :, None],
                                        torch.sqrt(1.0 + r * r) - 1.0, 0.0).sum()
        return float(total)

    def rmse(self, cam, pose):
        """Root mean square of the observed points' reprojection distances (px)."""
        sq, n = 0.0, 0
        for s in self.blocks():
            r = self.residual(cam, pose, s)
            sq += float((r * r).sum())
            n += int(self.mask[:, s].sum())
        return (sq / max(n, 1)) ** 0.5

    def normal_blocks(self, cam, pose):
        """IRLS normal equations of the soft-L1 cost at (cam, pose): U (C,
        12, 12), V (F, 6, 6), W (C, F, 12, 6), gradients g_cam (C, 12) and
        g_pose (F, 6). Every residual depends on its own camera and frame
        only, so one Jacobian of the residuals with respect to an 18-vector
        added to every camera and every pose gives all the blocks."""
        C, dev = cam.shape[0], cam.device
        U = torch.zeros((C, 12, 12), dtype=F64, device=dev)
        V = torch.zeros((self.F, 6, 6), dtype=F64, device=dev)
        W = torch.zeros((C, self.F, 12, 6), dtype=F64, device=dev)
        gc = torch.zeros((C, 12), dtype=F64, device=dev)
        gp = torch.zeros((self.F, 6), dtype=F64, device=dev)
        for s in self.blocks():
            p = pose[s]
            m = self.mask[:, s, :, None]

            def res(d):
                r = predict(cam + d[:12], p + d[12:], self.objp) - self.obs[:, s]
                return torch.where(m, r, 0.0)

            d0 = torch.zeros(18, dtype=F64, device=dev)
            J = torch.func.jacfwd(res)(d0)  # (C, Fb, N, 2, 18)
            r = res(d0)
            w = torch.where(m, 1.0 / torch.sqrt(1.0 + r * r), 0.0)
            Jc, Jp = J[..., :12], J[..., 12:]
            wJp = w[..., None] * Jp
            U += torch.einsum("cfnki,cfnkj->cij", w[..., None] * Jc, Jc)
            V[s] = torch.einsum("cfnki,cfnkj->fij", wJp, Jp)
            W[:, s] = torch.einsum("cfnki,cfnkj->cfij", Jc, wJp)
            gc += torch.einsum("cfnki,cfnk->ci", Jc, w * r)
            gp[s] = torch.einsum("cfnki,cfnk->fi", Jp, w * r)
        return U, V, W, gc, gp

    def polish(self, cam, pose, iters, lam=1e-6):
        """Levenberg-Marquardt on the soft-L1 cost from (cam, pose) for at
        most ``iters`` linearisations of at most three damping tries each:
        Marquardt damping of the block diagonals, the poses eliminated by
        their Schur complement. Returns the least cost reached."""
        C = cam.shape[0]
        best = self.cost(cam, pose)
        for _ in range(iters):
            U, V, W, gc, gp = self.normal_blocks(cam, pose)
            improved = False
            for _try in range(3):
                Ud = U + lam * torch.diag_embed(torch.diagonal(U, dim1=-2, dim2=-1)) \
                    + 1e-12 * torch.eye(12, dtype=F64, device=cam.device)
                Vd = V + lam * torch.diag_embed(torch.diagonal(V, dim1=-2, dim2=-1)) \
                    + 1e-12 * torch.eye(6, dtype=F64, device=cam.device)
                Vinv = torch.linalg.inv(Vd)
                T = torch.einsum("cfij,fjk->cfik", W, Vinv)  # W V^-1
                S = -torch.einsum("cfik,dfjk->cidj", T, W).reshape(12 * C, 12 * C)
                S += torch.block_diag(*Ud)
                rhs = -(gc - torch.einsum("cfik,fk->ci", T, gp)).reshape(-1)
                dc = torch.linalg.solve(S, rhs).reshape(C, 12)
                dp = -torch.einsum("fij,fj->fi", Vinv,
                                   gp + torch.einsum("cfij,ci->fj", W, dc))
                new = self.cost(cam + dc, pose + dp)
                if new < best:
                    cam, pose, best, improved = cam + dc, pose + dp, new, True
                    lam = max(lam / 3.0, 1e-12)
                    break
                lam *= 10.0
            if not improved:
                break
        return best


def select_frames(uvs, extrinsics, intrinsics, objp, poses, n_frames, seed, device):
    """The frames ``bundle_adjust`` should solve over: seen whole by two
    cameras or more, minus frames whose worst per-camera mean reprojection
    error at the given parameters exceeds 5 x the median error (the mean
    of the two middle errors where their count is even), subsampled to
    ``n_frames`` by ``numpy.random.default_rng(seed)``."""
    uvs = np.asarray(uvs, float)
    full = ~np.isnan(uvs).any((-1, -2))
    use = np.nonzero(full.sum(0) > 1)[0]
    cam = torch.as_tensor(camera_params(extrinsics, intrinsics), dtype=F64, device=device)
    prob = Problem(uvs[:, use], objp, device)
    pose = torch.as_tensor(np.asarray(poses, float)[use], dtype=F64, device=device)
    worst, errs = [], []
    for s in prob.blocks():
        m = prob.mask[:, s]
        err = torch.linalg.norm(predict(cam, pose[s], prob.objp) - prob.obs[:, s], dim=-1)
        n = m.sum(-1)
        mean = torch.where(n > 0, torch.where(m, err, 0.0).sum(-1) / n, -torch.inf)
        worst.append(mean.max(0).values)  # -inf: a frame no camera sees whole
        errs.append(err[m])
    errs = torch.sort(torch.cat(errs)).values
    k = len(errs)
    median = float(errs[k // 2]) if k % 2 else float(errs[k // 2 - 1] + errs[k // 2]) / 2
    use = use[~(torch.cat(worst) > 5 * median).cpu().numpy()]
    if n_frames is not None and n_frames < len(use):
        use = np.sort(np.random.default_rng(seed).choice(use, n_frames, replace=False))
    return use


def judge(uvs, start, result, objp, n_frames, polish_iters, device):
    """The numbers by which a ``bundle_adjust`` result is judged.

    ``start`` = (extrinsics, intrinsics, poses) it started from, ``result``
    = (extrinsics, intrinsics, poses, frames, final cost) it returned.
    ``frames_off``: frames in one selection and not the other. ``rmse_px``:
    reprojection RMSE of the result. ``cost_rel``: the reported cost's
    distance from the cost of the returned parameters, relative to it.
    ``excess`` (where ``polish_iters`` > 0): how much of that cost a float64
    LM polish from the result still removes, relative to what is left."""
    t0 = time.perf_counter()
    ext, intr, poses, frames, reported = result
    ref_frames = select_frames(uvs, start[0], start[1], objp, start[2], n_frames, 0, device)
    t1 = time.perf_counter()
    frames_off = len(np.setxor1d(ref_frames, np.asarray(frames)))
    prob = Problem(np.asarray(uvs, float)[:, np.asarray(frames)], objp, device)
    cam = torch.as_tensor(camera_params(ext, intr), dtype=F64, device=device)
    pose = torch.as_tensor(np.asarray(poses, float), dtype=F64, device=device)
    cost = prob.cost(cam, pose)
    numbers = {"frames_off": float(frames_off), "rmse_px": prob.rmse(cam, pose),
               "cost_rel": abs(float(reported) - cost) / cost}
    t2 = time.perf_counter()
    if polish_iters > 0:
        best = prob.polish(cam, pose, polish_iters)
        numbers["excess"] = (cost - best) / best
    print(f"perfbench: reference selection {t1 - t0:.3f} s, cost and RMSE {t2 - t1:.3f} s, "
          f"polish {time.perf_counter() - t2:.3f} s", file=sys.stderr)
    return numbers
