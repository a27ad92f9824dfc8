"""The corner-response kernel's plain twins against the JAX Pallas kernels.

``ops/corner_cuda.py`` holds the wrappers of the CUDA corner kernel and
their plain PyTorch twins; the wrappers refuse CPU tensors, and on the CPU
the detector runs the twins. The same
numpy inputs go through the twins and through the JAX package's
``corner_response_peaks_pallas`` / ``corner_response_pallas`` in interpret
mode (the Pallas kernels whose semantics the CUDA kernel follows). Both are
f32 stencil chains in different operation orders, so they agree to f32
rounding, at the tolerance of tests/test_pallas_kernels.py: 3e-6 x the
largest |response| of the SAME-convolution path on the same input (its
re-zeroed border puts that at the scale of the squared gray range), inside
the margin the detector masks (Gaussian radius + NMS radius + 4). Peak
masks are compared exactly with the NMS of the twin's own response.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from multicam_calibration_tpu.detection.detector import corner_response as jax_corner_response
from multicam_calibration_tpu.ops.pallas_kernels import (
    corner_response_pallas,
    corner_response_peaks_pallas,
)
from multicam_calibration_tpu_torch.detection import detector
from multicam_calibration_tpu_torch.detection.detector import (
    corner_response,
    find_corner_candidates,
)
from multicam_calibration_tpu_torch.ops import corner_cuda
from multicam_calibration_tpu_torch.utils.metrics import metrics

NMS = 4
SIGMAS = [1.5, 3.5, 6.0, 9.0]  # stage 1 and the coarse ladder (_COARSE_SCALES)
SHAPES = [(2, 100, 150), (1, 130, 131)]


def _gray(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _scale(g, sigma):
    """The tolerance scale of tests/test_pallas_kernels.py (see above)."""
    return float(np.abs(np.asarray(
        jax_corner_response(jnp.asarray(g), sigma=sigma, use_pallas=False)
    )).max())


def _nms_same(resp, n):
    """reduce_window NMS with -inf padding (the XLA path's peak rule)."""
    win = 2 * n + 1
    local_max = np.asarray(
        lax.reduce_window(
            jnp.asarray(resp), -jnp.inf, lax.max, (1, win, win), (1, 1, 1), "SAME"
        )
    )
    return (resp >= local_max) & (resp > 0)


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("shape", SHAPES, ids=["2x100x150", "1x130x131"])
def test_peaks_twin_matches_pallas(shape, sigma):
    g = _gray(shape)
    resp_j, peak_j = corner_response_peaks_pallas(
        jnp.asarray(g), sigma=sigma, nms_radius=NMS, interpret=True
    )
    resp_j, peak_j = np.asarray(resp_j), np.asarray(peak_j)
    resp_t, peak_t = corner_cuda.corner_response_peaks_reference(torch.as_tensor(g), sigma, NMS)
    resp_t, peak_t = resp_t.numpy(), peak_t.numpy()
    assert resp_t.shape == resp_j.shape and resp_t.dtype == np.float32
    assert peak_t.dtype == np.bool_
    m = int(3 * sigma + 0.5) + NMS + 4
    inner = (slice(None), slice(m, -m), slice(m, -m))
    np.testing.assert_allclose(resp_t[inner], resp_j[inner], atol=3e-6 * _scale(g, sigma))
    np.testing.assert_array_equal(peak_t[inner], _nms_same(resp_t, NMS)[inner])
    # The response of the peaks mode is that of the no-peaks mode, bit for bit.
    np.testing.assert_array_equal(
        resp_t, corner_cuda.corner_response_fused_reference(torch.as_tensor(g), sigma).numpy()
    )


@pytest.mark.parametrize("sigma", SIGMAS)
def test_fused_twin_matches_pallas(sigma):
    g = _gray((2, 100, 150), seed=1)
    ref = np.asarray(corner_response_pallas(jnp.asarray(g), sigma=sigma, interpret=True))
    out = corner_cuda.corner_response_fused_reference(torch.as_tensor(g), sigma).numpy()
    m = int(3 * sigma + 0.5) + 4
    np.testing.assert_allclose(
        out[:, m:-m, m:-m], ref[:, m:-m, m:-m], atol=3e-6 * _scale(g, sigma)
    )


@pytest.mark.parametrize("sigma", [1.5, 3.5, 6.0])
@pytest.mark.parametrize("shape", [(1, 64, 64), (3, 128, 256), (1, 130, 131)])
def test_conv_path_matches_jax_conv_path(shape, sigma):
    """impl="conv" is the JAX package's use_pallas=False path (SAME
    convolutions) in torch: equal to f32 rounding. Inside the margin at the
    kernels' tolerance; over the whole image at 1e-5 x scale, because the
    re-zeroed border band holds the largest responses, where the two
    libraries' convolutions sum the taps in other orders (measured up to
    ~5e-6 x scale there)."""
    g = _gray(shape, seed=2)
    ref = np.asarray(jax_corner_response(jnp.asarray(g), sigma=sigma, use_pallas=False))
    out = corner_response(torch.as_tensor(g), sigma=sigma, impl="conv").numpy()
    scale = float(np.abs(ref).max())
    m = int(3 * sigma + 0.5) + 4
    np.testing.assert_allclose(out[:, m:-m, m:-m], ref[:, m:-m, m:-m], atol=3e-6 * scale)
    np.testing.assert_allclose(out, ref, atol=1e-5 * scale)


def test_kernel_path_matches_conv_path_inside_border():
    g = _gray((2, 100, 150), seed=3)
    conv = corner_response(torch.as_tensor(g), impl="conv").numpy()
    kern = corner_response(torch.as_tensor(g)).numpy()
    m = 8
    np.testing.assert_allclose(
        kern[:, m:-m, m:-m], conv[:, m:-m, m:-m], atol=3e-6 * float(np.abs(conv).max())
    )
    with pytest.raises(ValueError):
        corner_response(torch.as_tensor(g), impl="pallas")


def test_wrappers_run_twins_on_cpu_and_count_no_launch(monkeypatch):
    """On CPU tensors the detector's two call sites choose the twins and
    launch nothing; the wrappers themselves refuse CPU tensors."""
    g = torch.as_tensor(_gray((1, 70, 90), seed=4))
    kernels = ("corner_peaks_kernel", "corner_response_kernel")
    before = [metrics.stage_times.get(f"{k}.launches", 0) for k in kernels]
    calls = []
    real = corner_cuda.corner_response_peaks_reference
    monkeypatch.setattr(detector, "corner_response_peaks_reference",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    find_corner_candidates(g, nms_radius=NMS, sigma=3.5)
    assert len(calls) == 1
    assert torch.equal(corner_response(g, 3.5), corner_cuda.corner_response_fused_reference(g, 3.5))
    assert [metrics.stage_times.get(f"{k}.launches", 0) for k in kernels] == before
    # f64 grays are cast down to f32, as the Pallas kernel does.
    resp, peak = real(g, 3.5, NMS)
    r64, p64 = real(g.double(), 3.5, NMS)
    assert r64.dtype == torch.float32 and torch.equal(r64, resp) and torch.equal(p64, peak)
    # The wrappers refuse a CPU tensor instead of running the twin.
    with pytest.raises(ValueError, match="CUDA tensor"):
        corner_cuda.corner_response_peaks(g, 1.5, NMS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        corner_cuda.corner_response_fused(g, 1.5)


def test_gaussian_taps_match_pallas_taps():
    """f64-normalized numpy taps, rounded to f32 (pallas_kernels.py:258-260)."""
    for sigma in SIGMAS:
        rg, taps = corner_cuda.gaussian_taps(sigma)
        k = np.exp(-0.5 * (np.arange(-rg, rg + 1) / sigma) ** 2)
        assert rg == int(3 * sigma + 0.5) and taps.dtype == np.float32
        np.testing.assert_array_equal(taps, np.float32(k / k.sum()))
    assert corner_cuda.gaussian_taps(9.0)[0] <= corner_cuda.MAX_RADIUS
