"""Hand-written CUDA kernel for the planar-pose Gauss-Newton polish.

``pose_gn_refine`` launches ``pose_gn_kernel`` (``csrc/pose_kernels.cu``,
sm_90a, plain C ABI, loaded with ctypes): one warp per camera-frame runs
both branches of the planar-pose polish of ``models.initialize`` (10
Gauss-Newton steps from the homography pose, the planar twin of the
result, 10 steps from the twin), compares their squared errors and keeps
the better, all in f64, in one launch per call. It replaces no TPU kernel:
the JAX package's ``_refine_poses_gn`` is jnp that XLA fuses.

The wrapper takes CUDA tensors only and refuses others. The plain PyTorch
twin, ``initialize.pose_gn_refine_reference`` (``_polish_poses`` vmapped
over cameras), lives beside the polish it vmaps, and
``initialize._estimate_poses`` chooses between the two. The launch goes
through ``_build.KernelLibrary``, which counts ``pose_gn_kernel.launches``
(``utils.metrics``).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import KernelLibrary, check_inputs, check_launch

__all__ = ["pose_gn_refine"]


def bind(lib):
    """Declare the C interface of a loaded ``pose_kernels`` library; returns it."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pose_gn_launch.argtypes = [ptr] * 5 + [i32, i32, i32, ptr, ptr]
    lib.pose_gn_launch.restype = i32
    lib.pose_error_string.argtypes = [i32]
    lib.pose_error_string.restype = ctypes.c_char_p
    return lib


_KERNELS = KernelLibrary("pose_kernels", bind)


def _check(poses0, cam12, uvs, mask, objpoints):
    """Validate the kernel's inputs. The kernel reads every input in place:
    f64 poses, cameras, detections and board points, a bool mask, all
    contiguous."""
    f64 = torch.float64
    check_inputs(("poses0", poses0, f64), ("cam12", cam12, f64), ("uvs", uvs, f64),
                 ("mask", mask, torch.bool), ("objpoints", objpoints, f64))
    C, F = mask.shape if mask.ndim == 2 else (-1, -1)
    N = objpoints.shape[0]
    if (mask.ndim != 2 or poses0.shape != (C, F, 6) or cam12.shape != (C, 12)
            or uvs.shape != (C, F, N, 2) or objpoints.shape != (N, 3)):
        raise ValueError(
            f"shapes: poses0 {tuple(poses0.shape)}, cam12 {tuple(cam12.shape)}, uvs "
            f"{tuple(uvs.shape)}, mask {tuple(mask.shape)}, objpoints {tuple(objpoints.shape)}")
    if N < 1:
        raise ValueError("the board has no points")


def _launch(lib, stream, poses0, cam12, uvs, mask, objpoints):
    """Allocate the output and launch the kernel on ``stream``; no other
    device work."""
    C, F = mask.shape
    out = torch.empty((C, F, 6), dtype=torch.float64, device=poses0.device)
    code = lib.pose_gn_launch(
        poses0.data_ptr(), cam12.data_ptr(), uvs.data_ptr(), mask.data_ptr(),
        objpoints.data_ptr(), C, F, objpoints.shape[0], out.data_ptr(), stream)
    check_launch(code, "pose_gn_kernel", lib.pose_error_string)
    return out


def pose_gn_refine(poses0, cam12, uvs, mask, objpoints):
    """Gauss-Newton polish of every camera-frame, both planar twins, the
    better kept.

    poses0 (C, F, 6) homography poses, cam12 (C, 12) cameras (fx, fy, cx,
    cy, k1, k2, then the extrinsics, which the polish takes as identity),
    uvs (C, F, N, 2) detections, mask (C, F) bool (frames fully detected),
    objpoints (N, 3). Returns (C, F, 6) f64, NaN rows where ``mask`` is
    false. The inputs must be CUDA tensors on one device, f64 (the mask
    bool) and contiguous, with any N >= 1 (a lane of the frame's warp takes
    every 32nd point): one kernel launch on the current stream and one
    allocation, no synchronisation.
    """
    _check(poses0, cam12, uvs, mask, objpoints)
    return _KERNELS.launch("pose_gn_kernel", _launch, poses0.device, poses0, cam12, uvs,
                           mask, objpoints)
