"""Masked robust reductions (median and mean) with static shapes.

Counterpart of ``multicam_calibration_tpu/ops/reductions.py``. The robust
consensus steps of calibration (pairwise-transform and consensus-pose
medians) take medians over masked entries; these sort-based reductions
reproduce ``np.nanmedian`` (even counts average the two middle values) and
follow the device and dtype of their input.
"""
from __future__ import annotations

import torch

__all__ = ["masked_median", "nanmedian", "masked_mean"]


def masked_median(values, mask, axis=-1):
    """Median of ``values`` where ``mask`` is True along ``axis``.

    Entries with mask=False are ignored; if no entry is valid the result is
    NaN. Matches ``np.nanmedian`` (even counts average the two middle
    values). One ``torch.sort`` over the axis.
    """
    values = values.movedim(axis, -1)
    mask = torch.as_tensor(mask, device=values.device)
    mask = mask.movedim(axis, -1).expand(values.shape)
    filled = torch.where(mask, values, torch.inf)
    n = mask.sum(-1)
    count = values.shape[-1]
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, count - 1)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, count - 1)
    s = torch.sort(filled, dim=-1).values
    v_lo = torch.take_along_dim(s, lo[..., None], dim=-1)[..., 0]
    v_hi = torch.take_along_dim(s, hi[..., None], dim=-1)[..., 0]
    med = 0.5 * (v_lo + v_hi)
    return torch.where(n > 0, med, torch.nan)


def nanmedian(values, axis=-1):
    """``np.nanmedian`` equivalent driven by a NaN mask."""
    return masked_median(torch.nan_to_num(values), ~torch.isnan(values), axis=axis)


def masked_mean(values, mask, axis=None):
    """Mean over masked entries; NaN where nothing is valid."""
    mask = torch.as_tensor(mask, device=values.device).expand(values.shape)
    kept = torch.where(mask, values, 0.0)
    if axis is None:
        total, count = kept.sum(), mask.sum()
    else:
        total, count = kept.sum(dim=axis), mask.sum(dim=axis)
    return torch.where(count > 0, total / torch.clamp(count, min=1), torch.nan)
