"""The CUDA source of the corner kernel, run on the CPU through a C++ shim.

``csrc/corner_kernels.cu`` is compiled with the host C++ compiler against
the shim of tests/test_torch_ba_kernels_emulated.py (one ``std::thread`` per
CUDA thread, ``std::barrier`` for ``__syncthreads``, a NaN-filled buffer for
dynamic shared memory, the rounded f32 intrinsics as plain f32 operations
built with ``-ffp-contract=off``). The library is bound with
``ops/corner_cuda.bind`` and driven through the wrapper's own launch
function on CPU tensors. The kernel rounds every multiply and add as the
plain twin does, in the same order, so the two are compared bit for bit:
a slip in a tile, a halo row or a tap fails here without a card. The shapes
are ragged against any tile; sigma 1.5, 3.5 and 9 take compile-time radii
5, 11 and 27, and sigma 2.0 (radius 6) the runtime-radius instantiation.
The low-band path's shapes (width 213, NMS radius 2) run at every radius of
its stage 1 and coarse ladder.
What only the card shows (nvcc's acceptance, spills, timing) is left to
chip_smoke.py and tests/test_torch_cuda.py. Skips where no C++20 compiler
is installed.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

from multicam_calibration_tpu_torch.ops import corner_cuda
from tests.test_torch_ba_kernels_emulated import build_emulated

SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "multicam_calibration_tpu_torch", "csrc", "corner_kernels.cu",
)
NMS = 4


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return corner_cuda.bind(build_emulated(
        SRC, tmp_path_factory.mktemp("corner_kernels_emulated"), ("-ffp-contract=off",)))


def _gray(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).random(shape, dtype=np.float32))


@pytest.mark.parametrize("peaks", [True, False], ids=["peaks", "response"])
@pytest.mark.parametrize("sigma", [1.5, 2.0, 3.5, 9.0])
@pytest.mark.parametrize("shape", [(2, 100, 150), (1, 130, 131), (1, 37, 300)])
def test_emulated_corner_kernel_matches_twin(lib, shape, sigma, peaks):
    gray = _gray(shape, seed=sum(shape))
    resp, peak = corner_cuda._launch(lib, 0, gray, sigma, NMS, peaks, "corner_kernel")
    if peaks:
        resp_t, peak_t = corner_cuda.corner_response_peaks_reference(gray, sigma, NMS)
        assert peak.dtype == torch.uint8
        assert torch.equal(peak.view(torch.bool), peak_t)
        assert bool(peak_t.any())
    else:
        assert peak is None
        resp_t = corner_cuda.corner_response_fused_reference(gray, sigma)
    assert torch.equal(resp, resp_t)


@pytest.mark.parametrize("sigma", [1.5, 3.5, 6.0, 9.0])
@pytest.mark.parametrize("shape", [(2, 120, 213), (1, 160, 213)])
def test_emulated_corner_kernel_at_low_band_shapes(lib, shape, sigma):
    """The low-band path's shapes (480 x 640 decimated by 4 and 3: an odd
    width of 213) at its NMS radius max(2, round(4 / f)) = 2, at the
    stage-1 sigma and the coarse ladder's."""
    gray = _gray(shape, seed=7 + sum(shape))
    resp, peak = corner_cuda._launch(lib, 0, gray, sigma, 2, True, "corner_kernel")
    resp_t, peak_t = corner_cuda.corner_response_peaks_reference(gray, sigma, 2)
    assert torch.equal(resp, resp_t)
    assert torch.equal(peak.view(torch.bool), peak_t) and bool(peak_t.any())


def test_emulated_relaunch_is_bit_identical_and_bad_radius_is_refused(lib):
    gray = _gray((1, 64, 96), seed=3)
    first = corner_cuda._launch(lib, 0, gray, 2.0, NMS, True, "corner_kernel")
    again = corner_cuda._launch(lib, 0, gray, 2.0, NMS, True, "corner_kernel")
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    taps = (ctypes.c_float * 65)(*([0.0] * 65))
    out = torch.empty((1, 64, 96))
    for rg, nms in ((corner_cuda.MAX_RADIUS + 1, NMS), (-1, NMS), (5, -1)):
        code = lib.corner_launch(gray.data_ptr(), 1, 64, 96, taps, rg, nms, 1,
                                 out.data_ptr(), out.data_ptr(), None)
        assert code != 0, (rg, nms)


def test_shared_memory_of_each_instantiation_fits_the_card(lib):
    """At nms 4 a compile-time radius leaves room for 2 blocks on an SM (228 KB,
    1 KB of it reserved per block), and the largest runtime radius fits one."""
    for rg in corner_cuda.RADII:
        assert 2 * (lib.corner_smem_bytes(rg, NMS, 1) + 1024) <= 228 * 1024, rg
        assert lib.corner_smem_bytes(rg, NMS, 0) < lib.corner_smem_bytes(rg, NMS, 1)
    assert lib.corner_smem_bytes(corner_cuda.MAX_RADIUS, NMS, 1) <= 232448
