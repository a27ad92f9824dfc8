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

__all__ = [
    "cam_params_from_jax",
    "poses_from_jax",
    "lm_options_from_jax",
    "rolling_state_from_jax",
]

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


# The state of a JAX ``RollingCalibrator`` that ``rolling_state_from_jax`` reads.
ROLLING_STATE = ("_ext", "_intr", "_obs_d", "_msk_d", "_poses_d", "_seen2d", "_order",
                 "_next_arrival", "_lam", "n_updates")


def rolling_state_from_jax(state: dict, calib_objpoints, **kwargs):
    """A port ``RollingCalibrator`` in the state of a JAX one.

    ``state`` maps the names of :data:`ROLLING_STATE` to numpy values (the
    JAX object's attributes through ``np.asarray``; ``_intr`` a list of
    (K, dist); ``_lam`` None before the first update). ``kwargs`` go to the
    port's constructor (``iters_per_update``, ``protect_recent``,
    ``refine_intrinsics``, ``dtype``, ``lm_options``, ``device``); the window
    size comes from the state. The device window is uploaded, the host
    eviction state copied, so the next ``update`` starts where JAX's would.
    """
    from .models.streaming import RollingCalibrator

    missing = [k for k in ROLLING_STATE if k not in state]
    if missing:
        raise ValueError(f"state lacks {missing}")
    obs = np.asarray(state["_obs_d"])
    cal = RollingCalibrator(state["_ext"], state["_intr"], calib_objpoints,
                            window=obs.shape[1], **kwargs)
    like = dict(dtype=cal._dtype, device=cal.device)
    cal._obs_d = torch.as_tensor(obs, **like)
    cal._msk_d = torch.as_tensor(np.asarray(state["_msk_d"], bool), device=cal.device)
    cal._poses_d = torch.as_tensor(np.asarray(state["_poses_d"]), **like)
    cal._seen2d = np.array(state["_seen2d"], bool)
    cal._order = np.array(state["_order"], np.int64)
    cal._next_arrival = int(state["_next_arrival"])
    cal._lam = None if state["_lam"] is None else float(state["_lam"])
    cal.n_updates = int(state["n_updates"])
    return cal
