"""Sparse Schur-complement Levenberg–Marquardt engine for bundle adjustment.

Counterpart of ``multicam_calibration_tpu/models/lm_core.py`` in eager
PyTorch. The design is the JAX engine's:

- **Analytic Jacobians**: each observation block (camera c, frame f)
  touches 12 camera and 6 pose parameters; closed-form chain-rule rows are
  computed batched over (C, F, N). The big sparse J is never formed.
- **Block normal equations**: per-camera 12x12 U_c, per-frame 6x6 V_f,
  cross blocks W_cf.
- **Schur complement**: batched damped 6x6 pose inverses, the dense
  12C x 12C camera system, then pose back-substitution.
- **Robust loss**: soft-L1 via IRLS weights, Jacobi equilibration of both
  solves.
- **Static shapes**: missing observations are weight-0 mask entries.
- **Chunked slab layout** (``frame_chunk``): the block build and the Schur
  reduction loop over frame slabs with the camera accumulators carried, so
  the per-observation Jacobian intermediates are O(C * frame_chunk); the
  pose and cross blocks stay O(C * F), as in the JAX layout.
- **Autodiff oracle** (``jacobian="jacfwd"``): ``torch.func.jacfwd`` of
  the per-(c, f) projection, the check of the analytic rows; never a
  default.

The JAX ``lax.while_loop`` becomes a host Python loop: each damping try
reads its cost back to decide acceptance. On CUDA tensors with the all-f32
recipe, the block build and the per-try cost run the hand-written kernels
of :mod:`..ops.ba_cuda` (the block build once per frame slab, the cost
once over all frames).

Not ported yet (ROADMAP.md, Queue 1): frame sharding (``axis_name``),
which raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..device import with_highest_precision
from ..ops import ba_cuda
from ..ops.rotation import so3_exp, so3_left_jacobian

__all__ = [
    "LMOptions",
    "accelerator_recipe",
    "HIST_FIELDS",
    "NormalBlocks",
    "project_board_points",
    "compute_residuals",
    "compute_cost",
    "build_normal_blocks",
    "schur_solve",
    "lm_solve",
]


@dataclasses.dataclass(frozen=True)
class LMOptions:
    """Optimizer options; fields and defaults as in the JAX ``LMOptions``.

    Defaults mirror the reference's scipy call: ftol=1e-4, soft_l1 loss
    with f_scale=1. The dtype fields name torch dtypes ("float32",
    "float64"); see the JAX class for the full rationale of each.
    """

    max_iters: int = 100
    max_tries: int = 10  # damping retries per outer iteration
    ftol: float = 1e-4
    gtol: float = 1e-12
    # Relative gradient stop: done when grad_norm < gtol_rel * (gradient
    # norm at the first linearization). 0.0 disables.
    gtol_rel: float = 0.0
    init_lambda: float = 1e-4
    lambda_up: float = 5.0
    # The t-th consecutive failed try in a round multiplies lambda by
    # lambda_up * lambda_escalation**t.
    lambda_escalation: float = 1.0
    lambda_down: float = 1.0 / 3.0
    # "classic": lambda *= lambda_down on acceptance. "nielsen":
    # lambda *= clip(1 - (2 rho - 1)^3, lambda_down, 2), rho the gain ratio.
    damping_schedule: str = "classic"
    min_lambda: float = 1e-12
    max_lambda: float = 1e8
    loss: str = "soft_l1"  # or "linear"
    f_scale: float = 1.0
    # Consecutive sub-ftol easy steps required to declare convergence.
    ftol_patience: int = 2
    # Dtype of the Schur reduction and solve (None: the data dtype).
    solve_dtype: str | None = None
    # Dtype of the Jacobian rows (None: the data dtype).
    jac_dtype: str | None = None
    # Dtype of the U/V/W contractions (None: the data dtype).
    block_dtype: str | None = None
    # Dtype of the per-try cost projection (None: the data dtype).
    cost_dtype: str | None = None
    # Dtype of the per-observation weighting and gradient products; the
    # residual and the frame reductions stay in the data dtype.
    grad_dtype: str | None = None
    # Frames per linearization chunk. None builds all (C, F) blocks at once;
    # an int loops the block build and the Schur reduction over slabs of
    # that many frames (the last one padded with zero poses and empty
    # masks). Only the per-observation intermediates are O(C * frame_chunk):
    # V, W and g_pose of all slabs are kept, O(C * F), as in the JAX layout.
    frame_chunk: int | None = None
    # Block build: "auto" runs the CUDA kernel (ops/ba_cuda.py) on CUDA
    # tensors whenever the options match what it implements (analytic
    # Jacobian, the all-f32 jac/block/grad/cost recipe, soft_l1/linear loss,
    # N*2 <= 128 board points) and the plain torch path otherwise; "torch"
    # never runs the kernel; "cuda" forces it and raises on CPU tensors or
    # an unsupported recipe.
    block_impl: str = "auto"
    # Per-try cost: "auto" runs the CUDA cost kernel (f64 residual, the same
    # chain as the block kernel, as the JAX package's Pallas route) on CUDA
    # tensors whenever the recipe holds (soft_l1/linear loss, N*2 <= 128,
    # cost_dtype="float32") and the plain torch path otherwise (on that
    # recipe an f32 projection, as the JAX package's XLA route); "torch"
    # never runs the kernel; "cuda" forces it and raises on CPU tensors or
    # an unsupported recipe. The JAX default is "xla", which carries over
    # as "torch" (convert.lm_options_from_jax).
    cost_impl: str = "auto"
    # "analytic": the closed-form rows of _analytic_pred_and_jacs.
    # "jacfwd": torch.func.jacfwd of the per-(c, f) projection, the
    # autodiff oracle the analytic rows are tested against (f64 roundoff);
    # it never runs the kernels.
    jacobian: str = "analytic"


HIST_FIELDS = ("cost", "grad_norm", "step_norm", "lambda", "tries", "rel_drop")

_ROADMAP = "not ported yet (ROADMAP.md, Queue 1: {})"


def accelerator_recipe(device, gtol_rel=1e-6):
    """The JAX package's numerics for f64 data off the CPU, as LMOptions
    fields: Jacobians, J^T J blocks, per-observation products, per-try cost
    and the Schur solve in f32, ``lambda_escalation=3.0`` and the relative
    gradient stop ``gtol_rel`` (its bundle_adjust's 1e-6; 0.0 for a solve of
    fixed iterations). On CUDA the recipe routes the block build and the
    per-try cost through the BA kernels. Empty on the CPU."""
    if torch.device(device).type == "cpu":
        return {}
    return dict(jac_dtype="float32", block_dtype="float32", cost_dtype="float32",
                solve_dtype="float32", grad_dtype="float32", gtol_rel=gtol_rel,
                lambda_escalation=3.0)


def _torch_dtype(name):
    """"float32" -> torch.float32; None -> None."""
    if name is None:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _no_sharding(axis_name):
    if axis_name is not None:
        raise NotImplementedError(
            "axis_name: " + _ROADMAP.format("frame-sharded solve")
        )


def _predict(cam_params, pose_params, objpoints):
    """Batched forward model: (C,12), (F,6), (N,3) -> pixels (C,F,N,2).

    Board -> world (pose), world -> camera (cam[6:]), perspective divide,
    radial k1, k2 on normalized coordinates, then fx, fy, cx, cy.
    """
    R_pose = so3_exp(pose_params[:, :3])  # (F,3,3)
    pts_world = objpoints @ R_pose.mT + pose_params[:, None, 3:]  # (F,N,3)
    R_cam = so3_exp(cam_params[:, 6:9])  # (C,3,3)
    pts_cam = (
        pts_world[None] @ R_cam[:, None].mT + cam_params[:, None, None, 9:12]
    )  # (C,F,N,3)
    x = pts_cam[..., 0] / pts_cam[..., 2]
    y = pts_cam[..., 1] / pts_cam[..., 2]
    cam = cam_params[:, None, None, :]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam[..., 4] + r2 * cam[..., 5])
    u = cam[..., 0] * (x * radial) + cam[..., 2]
    v = cam[..., 1] * (y * radial) + cam[..., 3]
    return torch.stack([u, v], dim=-1)


def project_board_points(cam12, pose6, objpoints):
    """Forward model for one (camera, frame) block: board points -> (N, 2)."""
    return _predict(cam12[None], pose6[None], objpoints)[0, 0]


def compute_residuals(cam_params, pose_params, obs, mask, objpoints):
    """Masked residuals (C, F, N, 2): (obs - pred) * mask (zeros where unseen)."""
    r = torch.nan_to_num(obs) - _predict(cam_params, pose_params, objpoints)
    return torch.where(mask[..., None], r, 0.0)


def _robust_weights(r2, opts: LMOptions):
    """Per-component IRLS weight sqrt(rho'(z)), z = r^2 / f_scale^2."""
    if opts.loss == "linear":
        return torch.ones_like(r2)
    z = r2 / (opts.f_scale**2)
    return (1.0 + z) ** -0.25


def _robust_cost(r2_masked, opts: LMOptions, axis=None):
    """0.5 * sum rho(r_i^2) with scipy's elementwise loss semantics."""
    if opts.loss == "linear":
        per = r2_masked
        scale = 0.5
    else:
        fs2 = opts.f_scale**2
        per = 2.0 * (torch.sqrt(1.0 + r2_masked / fs2) - 1.0)
        scale = 0.5 * fs2
    return scale * (per.sum() if axis is None else per.sum(dim=axis))


def _route(impl, name, ok, requirement, objpoints) -> bool:
    """Shared dispatch policy of the two kernels: "torch" never; "cuda"
    forces the kernel and raises on CPU tensors or an unsupported recipe;
    "auto" takes it exactly when the recipe holds on CUDA tensors."""
    if impl == "torch":
        return False
    if impl not in ("auto", "cuda"):
        raise ValueError(f"{name} must be auto|torch|cuda, got {impl!r}")
    on_cuda = objpoints.device.type == "cuda"
    if impl == "cuda":
        if not ok:
            raise ValueError(f"{name}='cuda' requires {requirement}")
        if not on_cuda:
            raise ValueError(f"{name}='cuda' requires CUDA tensors")
        return True
    return ok and on_cuda


def _kernel_params(*tensors):
    """The kernels' f64 contiguous layout; no copy for an f64 data dtype."""
    return [t.to(torch.float64).contiguous() for t in tensors]


def _kernel_loss_ok(opts: LMOptions, objpoints) -> bool:
    return (
        opts.loss in ("soft_l1", "linear")
        and objpoints.shape[0] * 2 <= ba_cuda.MAX_ROWS
    )


def _cuda_cost_eval(opts: LMOptions, data_dtype, objpoints) -> bool:
    """Dispatch: route compute_cost through the CUDA cost kernel?

    The kernel's f64 residual is more accurate than the
    cost_dtype="float32" projection it replaces, so the precondition is the
    f32-cost recipe.
    """
    ok = _kernel_loss_ok(opts, objpoints) and (
        _torch_dtype(opts.cost_dtype) == torch.float32
    )
    return _route(
        opts.cost_impl, "cost_impl", ok,
        "soft_l1/linear loss, N*2 <= 128 board points, and cost_dtype='float32'",
        objpoints,
    )


def _cuda_block_build(opts: LMOptions, data_dtype, objpoints) -> bool:
    """Dispatch: run the block build through the CUDA kernel?

    The kernel implements the analytic all-f32 recipe over an f64
    residual, soft_l1/linear loss and N*2 <= 128 board points.
    """
    eff = lambda v: _torch_dtype(v) if v else data_dtype  # noqa: E731
    ok = (
        opts.jacobian == "analytic"
        and _kernel_loss_ok(opts, objpoints)
        and all(
            eff(v) == torch.float32
            for v in (opts.jac_dtype, opts.block_dtype, opts.grad_dtype,
                      opts.cost_dtype)
        )
    )
    return _route(
        opts.block_impl, "block_impl", ok,
        "the analytic all-f32 recipe and N*2 <= 128 board points", objpoints,
    )


@with_highest_precision
def compute_cost(cam_params, pose_params, obs, mask, objpoints, opts,
                 axis_name=None):
    """Robust cost over all observations (a 0-d tensor in the data dtype).

    With ``opts.cost_dtype`` set, the projection and residual run in that
    dtype and only the reduction in the data dtype. With ``cost_impl``
    routing to the CUDA kernel, the residual is f64 and the per-(c, f) f32
    fragments are reduced in the data dtype: in the kernel for f64 data,
    here otherwise.
    """
    _no_sharding(axis_name)
    return _cost(cam_params, pose_params, obs, mask, objpoints, opts, None)


def _cost(cam_params, pose_params, obs, mask, objpoints, opts, prepared):
    """compute_cost with the kernel layout of (obs, mask) optionally given."""
    dtype = cam_params.dtype
    if _cuda_cost_eval(opts, dtype, objpoints):
        obs64, msk = (ba_cuda.ba_prepare_obs(obs, mask) if prepared is None
                      else (prepared.obs, prepared.msk))
        cam64, pose64, objp64 = _kernel_params(cam_params, pose_params, objpoints)
        frags, total = ba_cuda.ba_chunk_cost(
            cam64, pose64, obs64, msk, objp64,
            f_scale=opts.f_scale, loss_linear=(opts.loss == "linear"),
        )
        return total if dtype == torch.float64 else frags.to(dtype).sum()
    cd = _torch_dtype(opts.cost_dtype)
    if cd is not None and cd != dtype:
        r = compute_residuals(
            cam_params.to(cd), pose_params.to(cd), obs.to(cd), mask,
            objpoints.to(cd),
        ).to(dtype)
    else:
        r = compute_residuals(cam_params, pose_params, obs, mask, objpoints)
    r2 = torch.where(mask[..., None], r**2, 0.0)
    return _robust_cost(r2, opts)


class NormalBlocks(NamedTuple):
    """Block normal equations. U (C,12,12), g_cam (C,12) and cost (robust
    cost at the linearization point) in both layouts. Dense layout
    (frame_chunk None or >= F): V (F,6,6), W (C,F,12,6), g_pose (F,6).
    Chunked layout (``nc`` slabs of ``ck`` frames, F padded to nc*ck):
    V (nc,ck,6,6), W (nc,C,ck,12,6), g_pose (nc,ck,6); ``schur_solve``
    dispatches on W.ndim."""

    U: torch.Tensor
    V: torch.Tensor
    W: torch.Tensor
    g_cam: torch.Tensor
    g_pose: torch.Tensor
    cost: torch.Tensor


class _Prepared(NamedTuple):
    """The kernels' layout of (obs, mask), made once per solve: ``obs`` /
    ``msk`` over all frames (the cost kernel's input) and, for a chunked
    block build, ``slabs``, one contiguous (obs, msk) pair per frame slab."""

    obs: torch.Tensor
    msk: torch.Tensor
    slabs: tuple | None


def _pad_frames(x, axis, pad):
    """Zero-pad ``x`` by ``pad`` entries along its frame ``axis``."""
    if not pad:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _chunking(opts: LMOptions, F):
    """(chunk, pad, n_chunks) of the chunked layout, or None for dense."""
    chunk = opts.frame_chunk
    if chunk is None or chunk >= F:
        return None
    pad = (-F) % chunk
    return chunk, pad, (F + pad) // chunk


def _prepare(obs, mask, opts: LMOptions):
    """Kernel layout of (obs, mask), with the chunked build's slabs when the
    options chunk the frames."""
    obs64, msk = ba_cuda.ba_prepare_obs(obs, mask)
    chunking = _chunking(opts, mask.shape[1])
    slabs = None
    if chunking is not None:
        chunk, pad, nc = chunking
        o, m = _pad_frames(obs64, 1, pad), _pad_frames(msk, 1, pad)
        slabs = tuple(
            (o[:, k * chunk:(k + 1) * chunk].contiguous(),
             m[:, k * chunk:(k + 1) * chunk].contiguous())
            for k in range(nc)
        )
    return _Prepared(obs64, msk, slabs)


@with_highest_precision
def build_normal_blocks(
    cam_params, pose_params, obs, mask, objpoints, opts: LMOptions,
    cam_free=None, pose_free=None, axis_name=None,
):
    """Linearize at the current params and form block normal equations.

    ``cam_free`` (C, 12) / ``pose_free`` (F, 6) are 0/1 masks; frozen
    columns get zero Jacobian (their updates come out exactly 0 after the
    solve, whose zero diagonals are identity-padded in ``schur_solve``).
    With ``opts.frame_chunk`` < F the blocks come in the chunked layout of
    :class:`NormalBlocks`.
    """
    _no_sharding(axis_name)
    return _build(cam_params, pose_params, obs, mask, objpoints, opts,
                  cam_free, pose_free, None)


def _build(cam_params, pose_params, obs, mask, objpoints, opts, cam_free,
           pose_free, prepared):
    """build_normal_blocks with the kernel layout of (obs, mask) optionally
    given."""
    if opts.jacobian not in ("analytic", "jacfwd"):
        raise ValueError(f"jacobian must be analytic|jacfwd, got {opts.jacobian!r}")
    C, F = cam_params.shape[0], pose_params.shape[0]
    dtype = cam_params.dtype
    use_kernel = _cuda_block_build(opts, dtype, objpoints)
    if use_kernel and prepared is None:
        prepared = _prepare(obs, mask, opts)
    cf = None if cam_free is None else cam_free.to(dtype)

    def linearize(pose_k, obs_k, mask_k, kernel_obs, pose_free_k):
        """Blocks of one frame slab, the freezes applied. The freezes are
        per-camera resp. per-frame, so they distribute over the frame and
        camera sums: masking the reduced blocks is exact."""
        if kernel_obs is not None:
            U, V, W, g_cam, g_pose, cost = _linearize_kernel(
                cam_params, pose_k, kernel_obs, objpoints, opts)
        elif opts.jacobian == "analytic":
            U, V, W, g_cam, g_pose, cost = _linearize_analytic(
                cam_params, pose_k, obs_k, mask_k, objpoints, opts)
        else:
            U, V, W, g_cam, g_pose, cost = _linearize_jacfwd(
                cam_params, pose_k, obs_k, mask_k, objpoints, opts)
        if cf is not None:
            U = U * cf[:, :, None] * cf[:, None, :]
            W = W * cf[:, None, :, None]
            g_cam = g_cam * cf
        if pose_free_k is not None:
            pf = pose_free_k.to(pose_k.dtype)
            V = V * pf[:, :, None] * pf[:, None, :]
            W = W * pf[None, :, None, :]
            g_pose = g_pose * pf
        return U, V, W, g_cam, g_pose, cost

    chunking = _chunking(opts, F)
    if chunking is None:
        kernel_obs = (prepared.obs, prepared.msk) if use_kernel else None
        return NormalBlocks(*linearize(pose_params, obs, mask, kernel_obs, pose_free))

    # Chunked: loop over frame slabs; camera accumulators carried, per-frame
    # blocks emitted in the chunked layout (consumed chunked by schur_solve).
    chunk, pad, nc = chunking
    pose_c = _pad_frames(pose_params, 0, pad).reshape(nc, chunk, 6)
    pf_c = (None if pose_free is None
            else _pad_frames(pose_free, 0, pad).reshape(nc, chunk, 6))
    if not use_kernel:
        obs_p, mask_p = _pad_frames(obs, 1, pad), _pad_frames(mask, 1, pad)
    U = torch.zeros((C, 12, 12), dtype=dtype, device=cam_params.device)
    g_cam = torch.zeros((C, 12), dtype=dtype, device=cam_params.device)
    cost = torch.zeros((), dtype=dtype, device=cam_params.device)
    Vs, Ws, gps = [], [], []
    for k in range(nc):
        sl = slice(k * chunk, (k + 1) * chunk)
        U_k, V_k, W_k, gc_k, gp_k, cost_k = linearize(
            pose_c[k],
            None if use_kernel else obs_p[:, sl],
            None if use_kernel else mask_p[:, sl],
            prepared.slabs[k] if use_kernel else None,
            None if pf_c is None else pf_c[k],
        )
        U, g_cam, cost = U + U_k, g_cam + gc_k, cost + cost_k
        Vs.append(V_k)
        Ws.append(W_k)
        gps.append(gp_k)
    return NormalBlocks(U=U, V=torch.stack(Vs), W=torch.stack(Ws), g_cam=g_cam,
                        g_pose=torch.stack(gps), cost=cost)


def _linearize_kernel(cam_params, pose_k, kernel_obs, objpoints, opts):
    """Reduced blocks of one slab through the CUDA block kernel. Same dtype
    contracts as the plain analytic path: U/V/W accumulated f32 in the
    kernel, gradient and cost reductions in the data dtype."""
    dd = cam_params.dtype
    cam64, pose64, objp64 = _kernel_params(cam_params, pose_k, objpoints)
    Uf, Vf, Wf, gcam_f, gpose_f, cost_f = ba_cuda.ba_chunk_blocks(
        cam64, pose64, *kernel_obs, objp64,
        f_scale=opts.f_scale, loss_linear=(opts.loss == "linear"),
    )
    return (Uf.to(dd), Vf.to(dd), Wf.to(dd), gcam_f.to(dd).sum(1),
            gpose_f.to(dd).sum(0), cost_f.to(dd).sum())


def _linearize_jacfwd(cam_params, pose_params, obs, mask, objpoints, opts):
    """Reduced blocks through ``torch.func.jacfwd`` of the per-(c, f)
    projection: the autodiff oracle of the analytic path (the JAX package's
    ``per_cf``, lm_core.py:458-497).

    Per (c, f): the prediction in the data dtype, the 18 Jacobian columns in
    ``jac_dtype`` (kept there when ``grad_dtype`` is set too, else cast
    back), weights and products in ``grad_dtype``, U/V/W contractions in
    ``block_dtype``; every per-(c, f) block is cast to the data dtype
    before the frame and camera sums. The cost is the data dtype's.
    """
    from torch.func import jacfwd, vmap

    dd = cam_params.dtype
    jd = _torch_dtype(opts.jac_dtype) or dd
    objp_j = objpoints.to(jd)
    jac = jacfwd(lambda c, p: project_board_points(c, p, objp_j), argnums=(0, 1))
    A, B = vmap(vmap(jac, in_dims=(None, 0)), in_dims=(0, None))(
        cam_params.to(jd), pose_params.to(jd)
    )  # (C,F,N,2,12), (C,F,N,2,6)
    if not (opts.grad_dtype is not None and opts.jac_dtype is not None):
        A, B = A.to(dd), B.to(dd)
    m = mask[..., None]
    r = torch.where(m, torch.nan_to_num(obs) - _predict(cam_params, pose_params, objpoints), 0.0)
    w = torch.where(m, _robust_weights(r**2, opts), 0.0)
    cost = _robust_cost(torch.where(m, r**2, 0.0), opts, axis=(-2, -1))  # (C, F)
    if opts.grad_dtype is not None:
        gd = _torch_dtype(opts.grad_dtype)
        wg = w.to(gd)
        A = torch.where(m[..., None], A.to(gd) * wg[..., None], 0.0)
        B = torch.where(m[..., None], B.to(gd) * wg[..., None], 0.0)
        rw = (r * w).to(gd)
    else:
        A = torch.where(m[..., None], A * w[..., None], 0.0)
        B = torch.where(m[..., None], B * w[..., None], 0.0)
        rw = r * w
    bd = _torch_dtype(opts.block_dtype) or dd
    Ab, Bb = A.to(bd), B.to(bd)
    U = torch.einsum("cfnki,cfnkj->cfij", Ab, Ab).to(dd).sum(1)
    V = torch.einsum("cfnki,cfnkj->cfij", Bb, Bb).to(dd).sum(0)
    W = torch.einsum("cfnki,cfnkj->cfij", Ab, Bb).to(dd)
    g_cam = torch.einsum("cfnki,cfnk->cfi", A, rw).to(dd).sum(1)
    g_pose = torch.einsum("cfnki,cfnk->cfi", B, rw).to(dd).sum(0)
    return U, V, W, g_cam, g_pose, cost.sum()


def _analytic_pred_and_jacs(cam_params, pose_params, objpoints, jac_dtype=None):
    """Batched predictions + closed-form Jacobian blocks for all (c, f) pairs.

    cam_params (C,12), pose_params (F,6), objpoints (N,3) -> pred (C,F,N,2)
    in the data dtype; A (C,F,N,2,12), B (C,F,N,2,6) in ``jac_dtype``.

    With q = R_c (R_p b + t_p) + t_c, (x, y) = (q_x, q_y)/q_z,
    s(r2) = 1 + k1 r2 + k2 r2^2, (u, v) = (fx x s + cx, fy y s + cy):

      M   = diag(fx, fy) @ D @ G          (2x3 per point), where
      D   = [[s + 2x^2 s', 2xy s'], [2xy s', s + 2y^2 s']]
      G   = 1/q_z [[1, 0, -x], [0, 1, -y]]
      dq/dt_c = I,  dq/dr = -skew(R_c p_w) J_l(r)
      dq/dt_p = R_c, dq/drho = -R_c skew(R_p b) J_l(rho)

    m^T (-skew(w)) = cross(w, m)^T turns the skew products into cross
    products. Division by q_z is guarded (|q_z| < 1e-12 -> 1).
    """
    dtype = cam_params.dtype
    jd = _torch_dtype(jac_dtype) or dtype
    fx, fy = cam_params[:, 0], cam_params[:, 1]
    cx, cy = cam_params[:, 2], cam_params[:, 3]
    k1, k2 = cam_params[:, 4], cam_params[:, 5]
    rvec, tvec = cam_params[:, 6:9], cam_params[:, 9:12]
    rho, tp = pose_params[:, :3], pose_params[:, 3:]
    R_c = so3_exp(rvec)  # (C,3,3)
    R_p = so3_exp(rho)  # (F,3,3)

    Rb = torch.einsum("nj,fij->fni", objpoints, R_p)  # (F,N,3)
    p_w = Rb + tp[:, None, :]
    q = torch.einsum("fnj,cij->cfni", p_w, R_c) + tvec[:, None, None, :]
    Z = q[..., 2]
    Zs = torch.where(Z.abs() < 1e-12, torch.ones_like(Z), Z)
    invZp = 1.0 / Zs
    x, y = q[..., 0] * invZp, q[..., 1] * invZp
    r2 = x * x + y * y
    k1b, k2b = k1[:, None, None], k2[:, None, None]
    s = 1.0 + r2 * (k1b + r2 * k2b)
    xd, yd = x * s, y * s
    fxb, fyb = fx[:, None, None], fy[:, None, None]
    pred = torch.stack(
        [fxb * xd + cx[:, None, None], fyb * yd + cy[:, None, None]], -1
    )

    # Jacobian, entirely in jac_dtype: intermediates are reused from the
    # primal by casting. The left Jacobians are evaluated in the data dtype
    # and rounded, as the Pallas kernel does (ba_pallas.py:588, :603): an
    # f32 evaluation loses (1 - cos t) / t^2 to cancellation (all of it
    # just above the series switch, t = 1e-4; J_l off by ~5e-5 there).
    Jl_c = so3_left_jacobian(rvec).to(jd)
    Jl_p = so3_left_jacobian(rho).to(jd)
    if jd != dtype:
        x, y, r2, s, Zs, q, Rb, xd, yd = (
            v.to(jd) for v in (x, y, r2, s, Zs, q, Rb, xd, yd)
        )
        fxb, fyb, k1b, k2b = (v.to(jd) for v in (fxb, fyb, k1b, k2b))
        R_c = R_c.to(jd)
        tvec = tvec.to(jd)

    sp = k1b + 2.0 * k2b * r2  # s'(r2)
    d11 = s + 2.0 * x * x * sp
    d12 = 2.0 * x * y * sp
    d22 = s + 2.0 * y * y * sp
    invZ = 1.0 / Zs
    M0 = torch.stack([d11, d12, -(d11 * x + d12 * y)], -1) * (fxb * invZ)[..., None]
    M1 = torch.stack([d12, d22, -(d12 * x + d22 * y)], -1) * (fyb * invZ)[..., None]
    M = torch.stack([M0, M1], -2)  # (C,F,N,2,3)

    zero = torch.zeros_like(xd)
    one = torch.ones_like(xd)
    intr_cols = torch.stack(  # (C,F,N,2,6): d(u,v)/d(fx,fy,cx,cy,k1,k2)
        [
            torch.stack([xd, zero], -1),
            torch.stack([zero, yd], -1),
            torch.stack([one, zero], -1),
            torch.stack([zero, one], -1),
            torch.stack([fxb * x * r2, fyb * y * r2], -1),
            torch.stack([fxb * x * r2 * r2, fyb * y * r2 * r2], -1),
        ],
        -1,
    )
    w_cam = q - tvec[:, None, None, :]  # R_c p_w
    A_r = torch.einsum(
        "cfnkj,cji->cfnki", torch.linalg.cross(w_cam[..., None, :], M), Jl_c
    )
    A = torch.cat([intr_cols, A_r, M], dim=-1)  # (C,F,N,2,12)
    Mc = torch.einsum("cfnkj,cji->cfnki", M, R_c)
    B_r = torch.einsum(
        "cfnkj,fji->cfnki",
        torch.linalg.cross(Rb[None, :, :, None, :], Mc),
        Jl_p,
    )
    B = torch.cat([B_r, Mc], dim=-1)  # (C,F,N,2,6)
    return pred, A, B


def _analytic_fragments(cam_params, pose_params, obs, mask, objpoints, opts):
    """Per-slab normal-block fragments before the gradient/cost reductions.

    Returns (U (C,12,12), V (F,6,6), W (C,F,12,6) in block_dtype;
    g_cam (C,F,12), g_pose (C,F,6) in grad_dtype; cost (C,F) in
    cost_dtype). The residual is formed in the data dtype (obs - pred
    cancels ~4 digits); the robust weight and loss are smooth functions of
    it and run in grad_dtype / cost_dtype. Under the all-f32 recipe this is
    exactly what the CUDA block kernel emits (``ba_chunk_blocks``).
    """
    data_dtype = cam_params.dtype
    pred, A, B = _analytic_pred_and_jacs(
        cam_params, pose_params, objpoints, jac_dtype=opts.jac_dtype
    )
    m = mask[..., None]  # (C,F,N,1) -> broadcasts over the uv axis
    r = torch.where(m, torch.nan_to_num(obs) - pred, 0.0)  # data dtype
    gd = _torch_dtype(opts.grad_dtype) or data_dtype
    cd = _torch_dtype(opts.cost_dtype) or data_dtype
    bd = _torch_dtype(opts.block_dtype) or data_dtype
    r_g = r.to(gd)
    w = torch.where(m, _robust_weights(r_g**2, opts), 0.0)
    rho = _robust_cost(
        torch.where(m, r_g.to(cd) ** 2, 0.0), opts, axis=(-2, -1)
    )  # (C, F)
    Aw = torch.where(m[..., None], A.to(gd) * w[..., None], 0.0)
    Bw = torch.where(m[..., None], B.to(gd) * w[..., None], 0.0)
    rw = r_g * w
    Ab, Bb = Aw.to(bd), Bw.to(bd)
    U = torch.einsum("cfnki,cfnkj->cij", Ab, Ab)
    V = torch.einsum("cfnki,cfnkj->fij", Bb, Bb)
    W = torch.einsum("cfnki,cfnkj->cfij", Ab, Bb)
    g_cam = torch.einsum("cfnki,cfnk->cfi", Aw, rw)
    g_pose = torch.einsum("cfnki,cfnk->cfi", Bw, rw)
    return U, V, W, g_cam, g_pose, rho


def _linearize_analytic(cam_params, pose_params, obs, mask, objpoints, opts):
    """Reduced normal blocks via the analytic Jacobians.

    Returns (U (C,12,12), V (F,6,6), W (C,F,12,6), g_cam (C,12),
    g_pose (F,6), cost) in the data dtype. U/V/W contract in block_dtype;
    the gradient's frame/camera reduction and the cost's run in the data
    dtype (where the optimum's ~0 gradient emerges by cancellation).
    """
    dd = cam_params.dtype
    U, V, W, g_cam, g_pose, rho = _analytic_fragments(
        cam_params, pose_params, obs, mask, objpoints, opts
    )
    return (
        U.to(dd), V.to(dd), W.to(dd), g_cam.to(dd).sum(1),
        g_pose.to(dd).sum(0), rho.to(dd).sum(),
    )


def _cholesky(M):
    """Batched Cholesky factor; NaN where M is not positive definite.

    ``torch.linalg.cholesky`` raises on such a matrix and ``cholesky_ex``
    leaves the factor unspecified. JAX returns NaN, which makes the trial
    cost non-finite so the LM loop rejects the step; this keeps that.
    """
    L, info = torch.linalg.cholesky_ex(M)
    return L.masked_fill((info != 0)[..., None, None], float("nan"))


def _spd_solve(M, b):
    """Solve SPD M x = b via Cholesky (batched over leading dims)."""
    L = _cholesky(M)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def _spd_inverse(M):
    """Batched SPD inverse via Cholesky."""
    L = _cholesky(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(M.shape)
    y = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _equilibrated_solve(M, b):
    """Solve M x = b with Jacobi equilibration (keeps f32 solves stable)."""
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1), min=1e-30))
    Ms = M * d[..., :, None] * d[..., None, :]
    x = _spd_solve(Ms, b * d)
    return x * d


def _damp(M, lam, eps):
    """M + diag(lam * diag(M) + eps), identity-padding zero diagonals
    (frozen params / empty frames) so every block stays invertible with a
    zero update."""
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    return M + torch.diag_embed(lam * diag + eps + (diag <= 0).to(M.dtype))


@with_highest_precision
def schur_solve(blocks: NormalBlocks, lam, axis_name=None, eps=1e-12, opts=None):
    """Solve the damped normal equations via the Schur complement.

    Marquardt damping (lam * diag). Returns (dcam (C,12), dpose) in the
    blocks' dtype: dpose is (F,6) for dense blocks and (nc*ck, 6) for
    chunked ones (callers drop the padded rows, which are exactly 0). With
    ``opts.solve_dtype`` set the solve runs in that dtype.
    """
    _no_sharding(axis_name)
    C = blocks.U.shape[0]
    dtype = blocks.U.dtype
    sd = (
        _torch_dtype(opts.solve_dtype)
        if opts is not None and opts.solve_dtype
        else dtype
    )
    lam = float(lam)
    U_d = _damp(blocks.U.to(sd), lam, eps)
    g_cam = blocks.g_cam.to(sd)

    def reduce_slab(V, W, g_pose):
        """Schur contribution of one frame slab: S_cross, rhs_cross and the
        damped, equilibrated, batched SPD 6x6 pose-block inverses."""
        V_d = _damp(V, lam, eps)
        d = 1.0 / torch.sqrt(
            torch.clamp(torch.diagonal(V_d, dim1=-2, dim2=-1), min=1e-30)
        )
        scale = d[..., :, None] * d[..., None, :]
        V_inv = _spd_inverse(V_d * scale) * scale
        WVinv = torch.einsum("cfij,fjk->cfik", W, V_inv)
        S_cross = torch.einsum("afik,bfjk->aibj", WVinv, W)
        rhs_cross = torch.einsum("cfik,fk->ci", WVinv, g_pose)
        return S_cross, rhs_cross, V_inv

    def back_substitute(V_inv, W, g_pose, dcam):
        """dpose_f = V_f^-1 (g_pose_f - W_f^T dcam) for one frame slab."""
        Wt_dcam = torch.einsum("cfik,ci->fk", W, dcam)
        return torch.einsum("fij,fj->fi", V_inv, g_pose - Wt_dcam)

    V, W, g_pose = (x.to(sd) for x in (blocks.V, blocks.W, blocks.g_pose))
    if W.ndim == 4:  # dense
        slabs = [(V, W, g_pose)]
    else:  # chunked: the Schur reduction loops over the frame slabs
        slabs = list(zip(V, W, g_pose))
    # Slab sums in slab order; one slab (dense) adds and copies nothing.
    S_cross, rhs_cross, V_invs = zip(*(reduce_slab(*slab) for slab in slabs))
    S_cross = functools.reduce(torch.add, S_cross)
    rhs_cross = functools.reduce(torch.add, rhs_cross)
    S = torch.block_diag(*U_d) - S_cross.reshape(12 * C, 12 * C)
    rhs = (g_cam - rhs_cross).reshape(12 * C)
    dcam = _equilibrated_solve(S, rhs).reshape(C, 12)
    dpose = [back_substitute(V_inv_k, W_k, gp_k, dcam)
             for V_inv_k, (_, W_k, gp_k) in zip(V_invs, slabs)]
    dpose = dpose[0] if len(dpose) == 1 else torch.cat(dpose)
    return dcam.to(dtype), dpose.to(dtype)


def _diag_embed(diags):
    """(..., n) -> (..., n, n) diagonal matrices."""
    return torch.diag_embed(diags)


def _blockdiag_embed(blocks, C):
    """(C, 12, 12) -> (12C, 12C) block-diagonal."""
    return torch.block_diag(*blocks[:C])


@with_highest_precision
def lm_solve(
    cam_params,
    pose_params,
    obs,
    mask,
    objpoints,
    opts: LMOptions = LMOptions(),
    cam_free=None,
    pose_free=None,
    axis_name=None,
    init_lam=None,
    init_grad0=None,
):
    """Run the full LM loop; returns (cam, poses, info dict).

    Host loop over outer iterations, inner loop over damping retries
    (blocks reused across retries: only the Schur solve and a residual-only
    cost evaluation re-run). Each try reads its cost to the host to decide
    acceptance. ``init_lam`` overrides ``opts.init_lambda`` (a resumed run
    keeps its damping); ``init_grad0`` carries the first linearization's
    gradient norm so ``gtol_rel`` measures contraction from the true start.

    ``info`` holds Python scalars (``initial_cost``, ``final_cost``,
    ``n_iters``, ``lambda``, ``converged``, ``optimality``, ``nfev``,
    ``grad0``) and ``history``, a (max_iters, 6) tensor in the data dtype
    whose rows [:n_iters] hold :data:`HIST_FIELDS`.
    """
    _no_sharding(axis_name)
    dtype = cam_params.dtype
    F = pose_params.shape[0]
    prepared = None
    if _cuda_block_build(opts, dtype, objpoints) or _cuda_cost_eval(
        opts, dtype, objpoints
    ):
        prepared = _prepare(obs, mask, opts)

    def cost_fn(cam, poses):
        with record_function("lm_solve.cost"):
            return float(_cost(cam, poses, obs, mask, objpoints, opts, prepared))

    nielsen = opts.damping_schedule == "nielsen"
    cost0 = cost_fn(cam_params, pose_params)
    cam, poses, cost = cam_params, pose_params, cost0
    lam = float(opts.init_lambda if init_lam is None else init_lam)
    grad_norm = 0.0
    grad0 = -1.0 if init_grad0 is None else float(init_grad0)
    it, slow_steps, nfev, done = 0, 0, 1, False
    rows = []

    while not done and it < opts.max_iters:
        with record_function("lm_solve.build_normal_blocks"):
            blocks = _build(cam, poses, obs, mask, objpoints, opts, cam_free,
                            pose_free, prepared)
            grad_norm = float(torch.sqrt(
                torch.sum(blocks.g_cam**2) + torch.sum(blocks.g_pose**2)
            ))

        def gain_ratio(lam_t, dcam, dpose, cost_try):
            """rho = actual / predicted reduction; for the Marquardt step
            (A + lam*D) h = g the model reduction is 0.5 * h^T (lam*D*h + g)."""
            diag_u = torch.diagonal(blocks.U, dim1=-2, dim2=-1)
            diag_v = torch.diagonal(
                blocks.V.reshape(-1, 6, 6)[:F], dim1=-2, dim2=-1
            )
            g_pose = blocks.g_pose.reshape(-1, 6)[:F]
            term_cam = torch.sum(dcam * (lam_t * diag_u * dcam + blocks.g_cam))
            term_pose = torch.sum(dpose * (lam_t * diag_v * dpose + g_pose))
            pred = 0.5 * float(term_cam + term_pose)
            return (cost - cost_try) / max(pred, 1e-30)

        # Inner: retry with increasing damping until the cost decreases.
        cam_n, poses_n, cost_n = cam, poses, cost
        lam_t, lam_used, rho_used = lam, lam, 1.0
        tries, accepted = 0, False
        while not accepted and tries < opts.max_tries and lam_t < opts.max_lambda:
            with record_function("lm_solve.schur_solve"):
                dcam, dpose = schur_solve(blocks, lam_t, opts=opts)
            dpose = dpose[:F]  # chunked solves return padded rows
            cam_try = cam + dcam
            poses_try = poses + dpose
            cost_try = cost_fn(cam_try, poses_try)
            accepted = cost_try < cost and math.isfinite(cost_try)
            if nielsen:
                rho_used = gain_ratio(lam_t, dcam, dpose, cost_try)
            lam_used = lam_t
            if accepted:
                cam_n, poses_n, cost_n = cam_try, poses_try, cost_try
            else:
                lam_t = lam_t * (opts.lambda_up * opts.lambda_escalation**tries)
            tries += 1

        # On acceptance relax damping; on total failure keep raised lambda.
        if nielsen:
            relax = min(max(1.0 - (2.0 * rho_used - 1.0) ** 3, opts.lambda_down), 2.0)
        else:
            relax = opts.lambda_down
        lam = min(
            max(lam_used * relax if accepted else lam_t, opts.min_lambda),
            opts.max_lambda,
        )
        rel_drop = (cost - cost_n) / max(cost, 1e-30)
        # ftol only counts an unthrottled step (accepted at the first try);
        # a failed round is not termination unless lambda hit its ceiling.
        easy_step = accepted and tries == 1
        exhausted = not accepted and lam >= opts.max_lambda
        slow_steps = slow_steps + 1 if easy_step and rel_drop < opts.ftol else 0
        if grad0 < 0:
            grad0 = grad_norm
        done = (
            exhausted
            or slow_steps >= opts.ftol_patience
            or grad_norm < opts.gtol
            or (opts.gtol_rel > 0 and grad_norm < opts.gtol_rel * grad0)
        )
        step_norm = float(
            torch.sqrt(
                torch.sum((cam_n - cam) ** 2) + torch.sum((poses_n - poses) ** 2)
            )
        )
        rows.append([cost_n, grad_norm, step_norm, lam_used, float(tries), rel_drop])
        cam, poses, cost = cam_n, poses_n, cost_n
        it += 1
        nfev += tries

    hist = torch.zeros((opts.max_iters, len(HIST_FIELDS)), dtype=dtype,
                       device=cam_params.device)
    if rows:
        hist[: len(rows)] = torch.tensor(rows, dtype=dtype)
    info = {
        "initial_cost": cost0,
        "final_cost": cost,
        "n_iters": it,
        "lambda": lam,
        "converged": done,
        "optimality": grad_norm,  # scipy OptimizeResult.optimality
        "nfev": nfev,
        "grad0": grad0,
        "history": hist,  # (max_iters, 6), rows [:n_iters] valid
    }
    return cam, poses, info
