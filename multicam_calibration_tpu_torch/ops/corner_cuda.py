"""Hand-written CUDA kernel for the detection corner response (+ NMS peaks).

Counterpart of ``multicam_calibration_tpu/ops/pallas_kernels.py``. The kernel
lives in ``csrc/corner_kernels.cu`` (sm_90a, plain C ABI, loaded with
ctypes) as one template, ``corner_kernel<kPeaks, RG>``, compiled for the
Gaussian radii of the port's own paths (``RADII``: sigma 1.5, 3.5, 6 and 9)
and for RG = 0, which reads any other radius <= ``MAX_RADIUS`` at run time:

- ``corner_response_peaks`` launches it with peaks, replacing the Pallas
  ``_response_peaks_kernel``: Gaussian smoothing, Hessian saddle response
  and the (2 nms + 1)^2 local-max peak mask in one pass;
- ``corner_response_fused`` launches it without, replacing
  ``_response_kernel``: the response alone.

Semantics are the Pallas kernels', not the SAME-convolution path's: the
gray is zero outside the image, the smoothing runs through that halo, and
the response inside the NMS halo is computed from it (the two differ only
within a few pixels of the border, which ``find_corner_candidates`` masks).
The Gaussian taps are the f64-normalized numpy taps cast to f32.

Each wrapper has a plain PyTorch twin here (``*_reference``): shifted
multiply-adds in the Pallas order, a separable shifted max and the same zero
halo, one tensor op per rounding step, so kernel and twin agree bit for bit.
A wrapper takes CUDA tensors only and refuses others; the detector chooses
the twin for CPU tensors. The launches go through
``_build.KernelLibrary``, which counts ``corner_peaks_kernel.launches`` and
``corner_response_kernel.launches`` (``utils.metrics``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import KernelLibrary, check_inputs, check_launch

__all__ = [
    "gaussian_taps",
    "corner_response_peaks",
    "corner_response_peaks_reference",
    "corner_response_fused",
    "corner_response_fused_reference",
]

MAX_RADIUS = 31  # 2 rg + 1 <= 63 taps in the kernel's parameter block
RADII = (5, 11, 18, 27)  # radii with a compile-time instantiation (csrc: radius_instance)


def gaussian_taps(sigma):
    """(radius, taps): rg = int(3 sigma + 0.5) and the 2 rg + 1 normalized
    taps, computed in f64 and rounded to f32 (pallas_kernels.py:258-260)."""
    rg = int(3 * sigma + 0.5)
    k = np.exp(-0.5 * (np.arange(-rg, rg + 1) / sigma) ** 2)
    return rg, (k / k.sum()).astype(np.float32)


def _as_f32(gray):
    if gray.ndim != 3:
        raise ValueError(f"gray must be (B, H, W), got {tuple(gray.shape)}")
    return gray.to(torch.float32)


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def _response_ext(gray, sigma, ext):
    """Response over the image grown by ``ext`` pixels on every side: the
    Pallas stencil chain on the zero-padded gray. (B, H + 2 ext, W + 2 ext)."""
    rg, taps = gaussian_taps(sigma)
    taps = [float(t) for t in taps]  # exact f32 values
    halo = rg + 1 + ext
    x = torch.nn.functional.pad(_as_f32(gray), (halo, halo, halo, halo))
    wg = x.shape[2] - 2 * rg
    g1 = taps[0] * x[:, :, 0:wg]
    for t in range(1, 2 * rg + 1):
        g1 = g1 + taps[t] * x[:, :, t : t + wg]
    hg = x.shape[1] - 2 * rg
    g2 = taps[0] * g1[:, 0:hg]
    for t in range(1, 2 * rg + 1):
        g2 = g2 + taps[t] * g1[:, t : t + hg]
    ixx = g2[:, 1:-1, 0:-2] - 2.0 * g2[:, 1:-1, 1:-1] + g2[:, 1:-1, 2:]
    iyy = g2[:, 0:-2, 1:-1] - 2.0 * g2[:, 1:-1, 1:-1] + g2[:, 2:, 1:-1]
    ixy = 0.25 * (g2[:, 0:-2, 0:-2] + g2[:, 2:, 2:] - g2[:, 0:-2, 2:] - g2[:, 2:, 0:-2])
    return ixy * ixy - ixx * iyy


def corner_response_fused_reference(gray, sigma=1.5):
    """Plain PyTorch version of :func:`corner_response_fused`."""
    return _response_ext(gray, sigma, 0)


def corner_response_peaks_reference(gray, sigma=1.5, nms_radius=4):
    """Plain PyTorch version of :func:`corner_response_peaks`."""
    n = int(nms_radius)
    resp_ext = _response_ext(gray, sigma, n)
    H, W = resp_ext.shape[1] - 2 * n, resp_ext.shape[2] - 2 * n
    return resp_ext[:, n : n + H, n : n + W].contiguous(), peaks_of(resp_ext, n)


def peaks_of(resp_ext, nms_radius):
    """NMS of a response grown by ``nms_radius`` pixels on every side:
    (resp >= its (2 n + 1)^2 window max) & (resp > 0) on the inner image."""
    n = int(nms_radius)
    H, W = resp_ext.shape[1] - 2 * n, resp_ext.shape[2] - 2 * n
    mx = resp_ext[:, :, 0:W]
    for dx in range(1, 2 * n + 1):
        mx = torch.maximum(mx, resp_ext[:, :, dx : dx + W])
    m = mx[:, 0:H]
    for dy in range(1, 2 * n + 1):
        m = torch.maximum(m, mx[:, dy : dy + H])
    center = resp_ext[:, n : n + H, n : n + W]
    return (center >= m) & (center > 0)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def bind(lib):
    """Declare the C interface of a loaded ``corner_kernels`` library; returns it."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.corner_launch.argtypes = [
        ptr, i32, i32, i32, ctypes.POINTER(ctypes.c_float), i32, i32, i32, ptr, ptr, ptr,
    ]
    lib.corner_launch.restype = i32
    lib.corner_error_string.argtypes = [i32]
    lib.corner_error_string.restype = ctypes.c_char_p
    lib.corner_smem_bytes.argtypes = [i32, i32, i32]
    lib.corner_smem_bytes.restype = ctypes.c_longlong
    return lib


_KERNELS = KernelLibrary("corner_kernels", bind)


def _launch(lib, stream, gray, sigma, nms_radius, peaks, what):
    """Check the sizes, allocate the outputs and launch the kernel on
    ``stream``; no other device work. Returns (resp, peak or None)."""
    gray = _as_f32(gray).contiguous()
    B, H, W = gray.shape
    rg, taps = gaussian_taps(sigma)
    if rg > MAX_RADIUS or nms_radius < 0 or min(B, H, W) < 1 or B > 65535:
        raise ValueError(
            f"unsupported sigma {sigma} / nms_radius {nms_radius} / shape {(B, H, W)}"
        )
    resp = torch.empty_like(gray)
    peak = torch.empty(gray.shape, dtype=torch.uint8, device=gray.device) if peaks else None
    c_taps = (ctypes.c_float * len(taps))(*taps.tolist())
    code = lib.corner_launch(
        gray.data_ptr(), B, H, W, c_taps, rg, int(nms_radius), int(peaks),
        resp.data_ptr(), None if peak is None else peak.data_ptr(), stream,
    )
    check_launch(code, what, lib.corner_error_string)
    return resp, peak


def _on_card(gray, sigma, nms_radius, peaks, what):
    """Launch ``what`` on the current stream of the CUDA tensor's device."""
    check_inputs(("gray", gray, None))
    return _KERNELS.launch(what, _launch, gray.device, gray, sigma, nms_radius, peaks, what)


def corner_response_peaks(gray, sigma=1.5, nms_radius=4):
    """Fused saddle response and NMS peak mask over (B, H, W) grays.

    Returns (resp (B, H, W) f32, peak (B, H, W) bool) with
    peak = (resp >= its (2 nms_radius + 1)^2 window max) & (resp > 0).
    f64 grays are cast down to f32, as the Pallas kernel does.
    """
    resp, peak = _on_card(gray, sigma, nms_radius, True, "corner_peaks_kernel")
    return resp, peak.view(torch.bool)


def corner_response_fused(gray, sigma=1.5):
    """Saddle response Ixy^2 - Ixx * Iyy over (B, H, W) grays, f32."""
    return _on_card(gray, sigma, 0, False, "corner_response_kernel")[0]
