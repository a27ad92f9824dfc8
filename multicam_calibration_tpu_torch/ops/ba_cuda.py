"""Hand-written CUDA kernels for the bundle-adjustment block build and cost.

Counterpart of ``multicam_calibration_tpu/ops/ba_pallas.py``. The kernels
live in ``csrc/ba_kernels.cu`` (sm_90a, plain C ABI, loaded with ctypes):

- ``ba_chunk_blocks`` launches ``ba_blocks_kernel`` (one warp per
  (camera, frame) pair) and ``ba_reduce_kernel`` (V over cameras, U over
  frame tiles, in a fixed order), which together replace the Pallas
  ``_ba_kernel``: the fused linearization and normal-block build;
- ``ba_chunk_cost`` launches ``ba_cost_kernel`` (one block per camera and
  pair of frame tiles, the block kernel's front end), which replaces the Pallas
  ``_cost_kernel``: the per-damping-try robust cost, as per-(c, f) fragments
  and their f64 total.

The kernels take the raw parameters and compute the rotations and left
Jacobians themselves, so a wrapper does no tensor arithmetic on the card:
it checks its inputs, allocates its outputs and launches.

Each wrapper has a plain PyTorch twin in this module
(``ba_chunk_blocks_reference``, ``ba_chunk_cost_reference``) computing the
same fragments under the same precision contract. A wrapper runs its twin
only for tensors that lie on the CPU; for CUDA tensors it launches the
kernel or raises, and never falls back. Each wrapper counts its kernel
launches in a plain integer attribute, ``ba_chunk_blocks.launches`` and
``ba_chunk_cost.launches``, so a run can show which path it took.

Precision contract (ba_pallas.py:24-27): the residual is f64; Jacobian rows,
robust weights, in-frame products and in-tile sums are f32; every output is
an f32 fragment, and the caller reduces gradient and cost over frames and
cameras in f64 (the cost kernel also returns that f64 reduction itself).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch


__all__ = [
    "MAX_ROWS",
    "ba_prepare_obs",
    "ba_chunk_blocks",
    "ba_chunk_blocks_reference",
    "ba_chunk_cost",
    "ba_chunk_cost_reference",
]

MAX_ROWS = 128  # N*2 <= 128 (point, u/v) rows per frame: N <= 64 board points


def ba_prepare_obs(obs, mask):
    """Observations in the kernels' layout, once per solve.

    obs (C, F, N, 2), mask (C, F, N) bool -> (obs (C, F, N, 2) f64 with
    unobserved and NaN entries zeroed, msk (C, F, N) uint8), both
    contiguous. Constant across LM iterations: callers hoist it out of the
    optimizer loop.
    """
    N = obs.shape[2]
    if N * 2 > MAX_ROWS:
        raise ValueError(f"N*2 = {N * 2} exceeds the kernels' {MAX_ROWS} rows")
    obs = torch.where(mask[..., None], torch.nan_to_num(obs), 0.0)
    return obs.to(torch.float64).contiguous(), mask.to(torch.uint8).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def _recipe(f_scale, loss_linear):
    """The all-f32 LMOptions recipe the kernels implement."""
    from ..models.lm_core import LMOptions

    return LMOptions(
        loss="linear" if loss_linear else "soft_l1", f_scale=float(f_scale),
        jac_dtype="float32", block_dtype="float32", grad_dtype="float32",
        cost_dtype="float32",
    )


def ba_chunk_blocks_reference(
    cam_params, pose_k, obs, msk, objpoints, f_scale=1.0, loss_linear=False,
):
    """Plain PyTorch version of :func:`ba_chunk_blocks`, same fragments.

    lm_core's analytic linearization under the all-f32 recipe, without the
    frame and camera reductions of the gradient and cost.
    """
    from ..models.lm_core import _analytic_fragments

    f64 = torch.float64
    return _analytic_fragments(
        cam_params.to(f64), pose_k.to(f64), obs.to(f64), msk.bool(),
        objpoints.to(f64), _recipe(f_scale, loss_linear),
    )


def ba_chunk_cost_reference(
    cam_params, pose_k, obs, msk, objpoints, f_scale=1.0, loss_linear=False,
):
    """Plain PyTorch version of :func:`ba_chunk_cost`: (C, Fk) f32 fragments
    of the robust cost of the f64 residual, and their f64 sum (0-d)."""
    from ..models.lm_core import _robust_cost, compute_residuals

    f64 = torch.float64
    m = msk.bool()
    r = compute_residuals(
        cam_params.to(f64), pose_k.to(f64), obs.to(f64), m, objpoints.to(f64)
    ).to(torch.float32)
    r2 = torch.where(m[..., None], r**2, 0.0)
    frags = _robust_cost(r2, _recipe(f_scale, loss_linear), axis=(-2, -1))
    return frags, frags.to(f64).sum()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _lib():
    from ._build import load_library

    return bind(load_library("ba_kernels").lib)


def bind(lib):
    """Declare the C interface of a loaded ``ba_kernels`` library; returns it."""
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    head = [ptr] * 5 + [i32, i32, i32, f64, i32]
    lib.ba_blocks_launch.argtypes = head + [ptr] * 7 + [ptr]
    lib.ba_blocks_launch.restype = i32
    lib.ba_blocks_scratch_floats.argtypes = [i32, i32, i32]
    lib.ba_blocks_scratch_floats.restype = ctypes.c_longlong
    lib.ba_cost_launch.argtypes = head + [ptr] * 4 + [ptr]
    lib.ba_cost_scratch_doubles.argtypes = [i32, i32, i32]
    lib.ba_cost_scratch_doubles.restype = ctypes.c_longlong
    lib.ba_cost_launch.restype = i32
    lib.ba_error_string.argtypes = [i32]
    lib.ba_error_string.restype = ctypes.c_char_p
    return lib


def _check(cam_params, pose_k, obs, msk, objpoints):
    """Validate the kernels' inputs; returns (C, F, N).

    The kernels read every input in place: parameters and board points f64,
    obs/msk as :func:`ba_prepare_obs` makes them, all contiguous.
    """
    dev = cam_params.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {dev}")
    named = (("cam_params", cam_params), ("pose_k", pose_k), ("obs", obs),
             ("msk", msk), ("objpoints", objpoints))
    for name, t in named[1:]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cam_params on {dev}")
    C, F, N = msk.shape
    if cam_params.shape != (C, 12) or pose_k.shape != (F, 6):
        raise ValueError(
            f"shapes: cam {tuple(cam_params.shape)}, pose {tuple(pose_k.shape)}"
            f", msk {(C, F, N)}"
        )
    if obs.shape != (C, F, N, 2) or objpoints.shape != (N, 3):
        raise ValueError(
            f"shapes: obs {tuple(obs.shape)}, objpoints "
            f"{tuple(objpoints.shape)}, msk {(C, F, N)}"
        )
    if msk.dtype != torch.uint8:
        raise ValueError("msk must come from ba_prepare_obs (uint8)")
    for name, t in named:
        if name != "msk" and t.dtype != torch.float64:
            raise ValueError(f"{name} must be float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(C, F, N) < 1 or N * 2 > MAX_ROWS:
        raise ValueError(f"unsupported sizes C={C} F={F} N={N}")
    return C, F, N


def _raise_on(code, what):
    if code != 0:
        msg = _lib().ba_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {code})")


def _launch_blocks(lib, stream, cam_params, pose_k, obs, msk, objpoints,
                   f_scale, loss_linear):
    """Allocate the outputs (one flat f32 buffer, scratch included) and
    launch the block build on ``stream``; no other device work."""
    C, F, N = msk.shape
    shapes = ((C, 12, 12), (F, 6, 6), (C, F, 12, 6), (C, F, 12), (C, F, 6),
              (C, F))
    sizes = [math.prod(s) for s in shapes]
    scratch = lib.ba_blocks_scratch_floats(C, F, N)
    flat = torch.empty(sum(sizes) + scratch, dtype=torch.float32,
                       device=cam_params.device)
    parts = flat.split(sizes + [scratch])
    outs = tuple(p.view(s) for p, s in zip(parts, shapes))
    code = lib.ba_blocks_launch(
        cam_params.data_ptr(), pose_k.data_ptr(), objpoints.data_ptr(),
        obs.data_ptr(), msk.data_ptr(), C, F, N, float(f_scale),
        int(bool(loss_linear)), *(t.data_ptr() for t in outs),
        parts[-1].data_ptr(), stream,
    )
    _raise_on(code, "ba_blocks_kernel")
    return outs


@functools.cache
def _ticket(device, stream):
    """The cost kernel's arrival counter for launches on ``stream`` of
    ``device``: one int32, zero between launches (the last block to arrive
    resets it). One per stream, since only launches ordered on one stream
    may share it."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _launch_cost(lib, stream, cam_params, pose_k, obs, msk, objpoints,
                 f_scale, loss_linear):
    """Allocate the outputs (one f64 buffer: the total, the kernel's
    scratch, then the (C, F) f32 fragments) and launch the cost kernel on
    ``stream``; no other device work. Returns (fragments, total)."""
    C, F, N = msk.shape
    dev = cam_params.device
    head = 1 + lib.ba_cost_scratch_doubles(C, F, N)
    flat = torch.empty(head + (C * F + 1) // 2, dtype=torch.float64, device=dev)
    total = flat.select(0, 0)
    frags = flat.view(torch.float32).as_strided((C, F), (F, 1), 2 * head)
    out = flat.data_ptr()
    code = lib.ba_cost_launch(
        cam_params.data_ptr(), pose_k.data_ptr(), objpoints.data_ptr(),
        obs.data_ptr(), msk.data_ptr(), C, F, N, float(f_scale),
        int(bool(loss_linear)), out + 8 * head, out, out + 8,
        _ticket(dev, stream).data_ptr(), stream,
    )
    _raise_on(code, "ba_cost_kernel")
    return frags, total


def _on_card(launch, counted, cam_params, pose_k, obs, msk, objpoints,
             f_scale, loss_linear):
    """Check the inputs, launch on the current stream of their device and
    count the launch on ``counted``."""
    _check(cam_params, pose_k, obs, msk, objpoints)
    lib = _lib()
    dev = cam_params.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    # A launch goes to the thread's current device: switch only if needed.
    switch = torch.cuda.current_device() != dev.index
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        out = launch(lib, stream, cam_params, pose_k, obs, msk, objpoints,
                     f_scale, loss_linear)
    counted.launches += 1
    return out


def ba_chunk_blocks(
    cam_params, pose_k, obs, msk, objpoints, f_scale=1.0, loss_linear=False,
):
    """Fused block build for one frame chunk.

    cam_params (C, 12), pose_k (Fk, 6) and objpoints (N, 3) f64, obs/msk
    from :func:`ba_prepare_obs`, all contiguous. Returns (U (C,12,12),
    V (Fk,6,6), W (C,Fk,12,6), g_cam (C,Fk,12), g_pose (C,Fk,6),
    cost (C,Fk)), all f32 fragments: the caller reduces gradient and cost
    over frames and cameras in its data dtype. On the card: two kernel
    launches (``ba_blocks_kernel``, ``ba_reduce_kernel``) and one
    allocation, nothing else.
    """
    if cam_params.device.type == "cpu":
        return ba_chunk_blocks_reference(
            cam_params, pose_k, obs, msk, objpoints, f_scale, loss_linear
        )
    return _on_card(_launch_blocks, ba_chunk_blocks, cam_params, pose_k, obs,
                    msk, objpoints, f_scale, loss_linear)


def ba_chunk_cost(
    cam_params, pose_k, obs, msk, objpoints, f_scale=1.0, loss_linear=False,
):
    """Fused robust-cost evaluation for one frame chunk.

    Same inputs as :func:`ba_chunk_blocks`; returns (fragments, total):
    the per-(c, f) f32 cost fragments (C, Fk) of the f64 residual, and
    their sum as a 0-d f64 tensor, each fragment cast to f64 and added in a
    fixed order (``fragments.to(float64).sum()``; a caller with another data
    dtype reduces the fragments itself). On the card: one kernel launch and
    one allocation, nothing else.
    """
    if cam_params.device.type == "cpu":
        return ba_chunk_cost_reference(
            cam_params, pose_k, obs, msk, objpoints, f_scale, loss_linear
        )
    return _on_card(_launch_cost, ba_chunk_cost, cam_params, pose_k, obs, msk,
                    objpoints, f_scale, loss_linear)


ba_chunk_blocks.launches = 0
ba_chunk_cost.launches = 0
