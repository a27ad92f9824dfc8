"""Carry parameters and options over from the JAX package.

The inputs are plain numpy arrays and dicts, so this module needs no JAX:
``np.asarray`` of a JAX array, or ``dataclasses.asdict`` of a JAX
``LMOptions``. The outputs are tensors in the requested dtype and device, so
both packages compute the same thing from the same start.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.lm_core import LMOptions

__all__ = ["cam_params_from_jax", "poses_from_jax", "lm_options_from_jax"]

# JAX implementation names -> the port's.
_IMPL = {"xla": "torch", "pallas": "cuda", "auto": "auto"}


def _tensor(x, cols, name, dtype, device):
    a = np.asarray(x)
    if a.ndim != 2 or a.shape[1] != cols:
        raise ValueError(f"{name} must be (n, {cols}), got {a.shape}")
    return torch.as_tensor(a, dtype=dtype, device=device)


def cam_params_from_jax(cam, dtype=torch.float64, device=None):
    """(C, 12) camera parameters in the reference layout -> tensor."""
    return _tensor(cam, 12, "cam", dtype, device)


def poses_from_jax(poses, dtype=torch.float64, device=None):
    """(F, 6) board poses [axis-angle | translation] -> tensor."""
    return _tensor(poses, 6, "poses", dtype, device)


def lm_options_from_jax(fields: dict) -> LMOptions:
    """JAX ``LMOptions`` fields (``dataclasses.asdict``) -> port ``LMOptions``.

    ``block_impl``/``cost_impl`` map "xla" -> "torch", "pallas" -> "cuda",
    so options carried over keep the JAX package's route (its default
    ``cost_impl="xla"`` becomes "torch", not the port's default "auto");
    every other field carries over unchanged, and a field that is absent
    takes the port's default. Unknown fields raise.
    """
    fields = dict(fields)
    for key in ("block_impl", "cost_impl"):
        if key in fields:
            fields[key] = _IMPL[fields[key]]
    return LMOptions(**fields)
