"""Device and float32-precision policy for the PyTorch port.

Counterpart of ``multicam_calibration_tpu/ops/precision.py``. On the TPU the
hazard was bf16 MXU passes; on an NVIDIA GPU it is TF32, which keeps ~10
mantissa bits. Calibration geometry multiplies ~1e3-magnitude coordinates
(mm translations, pixel focal lengths), so a TF32 product injects noise far
above the sub-pixel residuals bundle adjustment minimizes. Every entry point
on the compute path therefore runs with TF32 off for both matmul and cuDNN.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["cuda_device", "resolve_device", "with_highest_precision"]


def with_highest_precision(fn):
    """Decorator: run ``fn`` with full-f32 matmuls and convolutions (no
    TF32), restoring the caller's settings afterwards."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = (
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision(),
        )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved[0]
            torch.backends.cudnn.allow_tf32 = saved[1]
            torch.set_float32_matmul_precision(saved[2])

    return wrapped


def cuda_device(index: int | None = None) -> torch.device:
    """The CUDA device the card path runs on; raises when there is none.

    None means the current device: card 0, or the card a process of a
    multi-process run selected (``torch.cuda.set_device``; under
    ``torchrun`` its ``LOCAL_RANK``). There is deliberately no CPU fallback:
    a measurement or kernel run that silently lands on the CPU would report
    CPU numbers as device numbers.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    if index is None:
        index = torch.cuda.current_device()
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"CUDA device {index} requested, {torch.cuda.device_count()} present"
        )
    return torch.device("cuda", index)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means :func:`cuda_device` (and
    raises without one). Entry points that take numpy input use this, so
    the CPU runs only when the caller asks for it."""
    return cuda_device() if device is None else torch.device(device)
