"""Hand-written CUDA kernel for the planar-pose Gauss-Newton polish.

``pose_gn_refine`` launches ``pose_gn_kernel`` (``csrc/pose_kernels.cu``,
sm_90a, plain C ABI, loaded with ctypes): one warp per camera-frame runs
both branches of the planar-pose polish of ``models.initialize`` (10
Gauss-Newton steps from the homography pose, the planar twin of the
result, 10 steps from the twin), compares their squared errors and keeps
the better, all in f64, in one launch per call. It replaces no TPU kernel:
the JAX package's ``_refine_poses_gn`` is jnp that XLA fuses.

The plain PyTorch twin, ``pose_gn_refine_reference``, is
``initialize._polish_poses`` vmapped over cameras: the polish as the JAX
package writes it, ``torch.func.jacfwd`` rows and a batched Cholesky per
step. The wrapper runs the twin only for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises, and never falls back. It
counts its launches in the plain integer ``pose_gn_refine.launches``, and
the camera-frames the kernel refined in the ``utils.metrics`` counter
``estimate_pose.gn_kernel.frames`` (0 for a call on the CPU).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..utils.metrics import metrics

__all__ = ["pose_gn_refine", "pose_gn_refine_reference"]

COUNTER = "estimate_pose.gn_kernel.frames"


def pose_gn_refine_reference(poses0, cam12, uvs, mask, objpoints):
    """Plain PyTorch version of :func:`pose_gn_refine`, same arguments:
    ``initialize._polish_poses`` vmapped over cameras."""
    from ..models.initialize import _polish_poses

    return torch.vmap(_polish_poses, in_dims=(0, 0, 0, 0, None))(
        poses0, cam12, uvs, mask, objpoints)


@functools.cache
def _lib():
    from ._build import load_library

    return bind(load_library("pose_kernels").lib)


def bind(lib):
    """Declare the C interface of a loaded ``pose_kernels`` library; returns it."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pose_gn_launch.argtypes = [ptr] * 5 + [i32, i32, i32, ptr, ptr]
    lib.pose_gn_launch.restype = i32
    lib.pose_error_string.argtypes = [i32]
    lib.pose_error_string.restype = ctypes.c_char_p
    return lib


def _check(poses0, cam12, uvs, mask, objpoints):
    """Validate the kernel's inputs; returns (C, F, N). The kernel reads
    every input in place: f64 poses, cameras, detections and board points,
    a bool mask, all contiguous."""
    dev = poses0.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    named = (("poses0", poses0), ("cam12", cam12), ("uvs", uvs), ("mask", mask),
             ("objpoints", objpoints))
    for name, t in named[1:]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, poses0 on {dev}")
    C, F = mask.shape if mask.ndim == 2 else (-1, -1)
    N = objpoints.shape[0]
    if (mask.ndim != 2 or poses0.shape != (C, F, 6) or cam12.shape != (C, 12)
            or uvs.shape != (C, F, N, 2) or objpoints.shape != (N, 3)):
        raise ValueError(
            f"shapes: poses0 {tuple(poses0.shape)}, cam12 {tuple(cam12.shape)}, uvs "
            f"{tuple(uvs.shape)}, mask {tuple(mask.shape)}, objpoints {tuple(objpoints.shape)}")
    if mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool, got {mask.dtype}")
    for name, t in named:
        if name != "mask" and t.dtype != torch.float64:
            raise ValueError(f"{name} must be float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N < 1:
        raise ValueError("the board has no points")
    return C, F, N


def _launch(lib, stream, poses0, cam12, uvs, mask, objpoints):
    """Allocate the output and launch the kernel on ``stream``; no other
    device work."""
    C, F = mask.shape
    out = torch.empty((C, F, 6), dtype=torch.float64, device=poses0.device)
    code = lib.pose_gn_launch(
        poses0.data_ptr(), cam12.data_ptr(), uvs.data_ptr(), mask.data_ptr(),
        objpoints.data_ptr(), C, F, objpoints.shape[0], out.data_ptr(), stream)
    if code != 0:
        msg = lib.pose_error_string(code).decode()
        raise RuntimeError(f"pose_gn_kernel launch failed: {msg} (cudaError {code})")
    return out


def pose_gn_refine(poses0, cam12, uvs, mask, objpoints):
    """Gauss-Newton polish of every camera-frame, both planar twins, the
    better kept.

    poses0 (C, F, 6) homography poses, cam12 (C, 12) cameras (fx, fy, cx,
    cy, k1, k2, then the extrinsics, which the polish takes as identity),
    uvs (C, F, N, 2) detections, mask (C, F) bool (frames fully detected),
    objpoints (N, 3). Returns (C, F, 6) f64, NaN rows where ``mask`` is
    false. On the card the inputs must be f64 (the mask bool), contiguous,
    on one device, with any N >= 1 (a lane of the frame's warp takes
    every 32nd point): one kernel launch on the current stream and one
    allocation, no synchronisation.
    """
    if poses0.device.type == "cpu":
        metrics.count(COUNTER, 0)
        return pose_gn_refine_reference(poses0, cam12, uvs, mask, objpoints)
    C, F, _ = _check(poses0, cam12, uvs, mask, objpoints)
    lib = _lib()
    dev = poses0.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    # A launch goes to the thread's current device: switch only if needed.
    switch = torch.cuda.current_device() != dev.index
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        out = _launch(lib, stream, poses0, cam12, uvs, mask, objpoints)
    pose_gn_refine.launches += 1
    metrics.count(COUNTER, C * F)
    return out


pose_gn_refine.launches = 0
