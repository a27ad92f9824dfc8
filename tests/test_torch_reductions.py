"""Masked reductions of the port vs the JAX package and ``np.nanmedian``.

The same seeded numpy values (with many ties: small integers), masks with
all-masked rows and even and odd counts, along several axes; the JAX
function runs both of its branches (its rank selection for axes of <= 32
entries, its sort beyond). Medians select and average exact values, so the
three agree exactly (NaN where nothing is valid); means at rtol 1e-15.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multicam_calibration_tpu.ops import reductions as jred
from multicam_calibration_tpu_torch.ops import reductions as tred


def _values(shape, seed):
    """Ties (small integers), a few non-integers, masks with empty rows."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 4, size=shape).astype(np.float64)
    frac = rng.random(shape) < 0.2
    v[frac] += rng.normal(size=int(frac.sum()))
    m = rng.random(shape) < 0.6
    m.reshape(-1, shape[-1])[0] = False  # an all-masked row
    m.reshape(-1, shape[-1])[1] = True
    return v, m


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("count", [7, 8, 40])  # odd, even, JAX's sort branch
def test_masked_median_matches_jax_and_numpy(count, axis):
    shape = (count, 9) if axis == 0 else (5, 9, count)
    v, m = _values(shape, count)
    if axis == 0:
        m[:, 0] = False  # an all-masked column along axis 0
    got = tred.masked_median(torch.as_tensor(v), torch.as_tensor(m), axis=axis).numpy()
    ref = np.asarray(jred.masked_median(jnp.asarray(v), jnp.asarray(m), axis=axis))
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        npy = np.nanmedian(np.where(m, v, np.nan), axis=axis)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, npy)
    assert np.isnan(got).any()  # the all-masked rows


def test_masked_median_broadcast_mask():
    """A (F, 1) frame mask against (F, 6) values, as the pairwise transform
    median calls it."""
    v, _ = _values((30, 6), 1)
    m = np.random.default_rng(2).random((30, 1)) < 0.5
    got = tred.masked_median(torch.as_tensor(v), torch.as_tensor(m), axis=0).numpy()
    ref = np.asarray(jred.masked_median(jnp.asarray(v), jnp.asarray(m), axis=0))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("count", [6, 33])
def test_nanmedian_matches_jax_and_numpy(count):
    v, m = _values((4, count), count)
    x = np.where(m, v, np.nan)
    got = tred.nanmedian(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jred.nanmedian(jnp.asarray(x))))
    with pytest.warns(RuntimeWarning):
        np.testing.assert_array_equal(got, np.nanmedian(x, axis=-1))


@pytest.mark.parametrize("axis", [None, 0, -1])
def test_masked_mean_matches_jax(axis):
    v, m = _values((6, 10), 3)
    got = tred.masked_mean(torch.as_tensor(v), torch.as_tensor(m), axis=axis).numpy()
    ref = np.asarray(jred.masked_mean(jnp.asarray(v), jnp.asarray(m), axis=axis))
    np.testing.assert_allclose(got, ref, rtol=1e-15)
    none = tred.masked_mean(torch.as_tensor(v), torch.zeros(6, 10, dtype=torch.bool))
    assert torch.isnan(none)
