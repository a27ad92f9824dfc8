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

The wrappers take CUDA tensors only and refuse others: the plain PyTorch
twins (``ba_chunk_blocks_reference``, ``ba_chunk_cost_reference``), which
compute the same fragments under the same precision contract, live beside
the analytic linearization in ``models.lm_core``, whose dispatch
(``lm_core._route``) chooses between kernel and twin. A wrapper launches
through ``_build.KernelLibrary``, which counts ``ba_blocks_kernel.launches``
and ``ba_cost_kernel.launches`` (``utils.metrics``), one per wrapper call.

Precision contract (ba_pallas.py:24-27): the residual is f64; Jacobian rows,
robust weights, in-frame products and in-tile sums are f32; every output is
an f32 fragment, and the caller reduces gradient and cost over frames and
cameras in f64 (the cost kernel also returns that f64 reduction itself).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import KernelLibrary, check_inputs, check_launch

__all__ = ["MAX_ROWS", "ba_prepare_obs", "ba_chunk_blocks", "ba_chunk_cost"]

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


_KERNELS = KernelLibrary("ba_kernels", bind)


def _check(cam_params, pose_k, obs, msk, objpoints):
    """Validate the kernels' inputs. The kernels read every input in place: parameters and board points f64,
    obs/msk as :func:`ba_prepare_obs` makes them, all contiguous."""
    f64 = torch.float64
    check_inputs(("cam_params", cam_params, f64), ("pose_k", pose_k, f64), ("obs", obs, f64),
                 ("msk", msk, torch.uint8), ("objpoints", objpoints, f64))
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
    if min(C, F, N) < 1 or N * 2 > MAX_ROWS:
        raise ValueError(f"unsupported sizes C={C} F={F} N={N}")


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
    check_launch(code, "ba_blocks_kernel", lib.ba_error_string)
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
    check_launch(code, "ba_cost_kernel", lib.ba_error_string)
    return frags, total


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
    _check(cam_params, pose_k, obs, msk, objpoints)
    return _KERNELS.launch("ba_blocks_kernel", _launch_blocks, cam_params.device, cam_params,
                           pose_k, obs, msk, objpoints, f_scale, loss_linear)


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
    _check(cam_params, pose_k, obs, msk, objpoints)
    return _KERNELS.launch("ba_cost_kernel", _launch_cost, cam_params.device, cam_params,
                           pose_k, obs, msk, objpoints, f_scale, loss_linear)
