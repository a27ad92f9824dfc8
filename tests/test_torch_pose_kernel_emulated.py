"""The CUDA source of the pose kernel, run on the CPU through a C++ shim.

``csrc/pose_kernels.cu`` is compiled with the host C++ compiler against the
shim of tests/test_torch_ba_kernels_emulated.py (one ``std::thread`` per
CUDA thread, ``std::barrier`` for ``__syncwarp`` and the shuffles; its lane
buffer is f64, so the kernel's f64 shuffles pass exactly). The library is
bound with ``ops/pose_cuda.bind`` and driven through the wrapper's own
launch function on CPU tensors, then held to the plain twin at the
tolerances of tests/test_torch_cuda.py (``_assert_poses_match``), on the
bench's 5 x 7 board and on a 7 x 10 board (70 points, 3 a lane): the
kernel's indexing, its derivatives, shuffle sums, Cholesky, planar twin and
branch choice are checked without a card. What only the card shows (nvcc's
acceptance, spills, timing, FMA contraction) is left to
tests/test_torch_cuda.py. Skips where no C++20 compiler is installed.
"""
import os

import numpy as np
import pytest
import torch

import multicam_calibration_tpu_torch as mct
from multicam_calibration_tpu_torch.models import initialize as tinit
from multicam_calibration_tpu_torch.ops import pose_cuda
from multicam_calibration_tpu_torch.utils.metrics import metrics
from tests.test_torch_ba_kernels_emulated import build_emulated
from tests.test_torch_cuda import _assert_poses_match, _pose_problem, _singular_problem

SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "multicam_calibration_tpu_torch", "csrc", "pose_kernels.cu",
)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return pose_cuda.bind(build_emulated(SRC, tmp_path_factory.mktemp("pose_kernels_emulated")))


def _estimate_poses_inputs():
    """(uvs, K, dist, objpoints) of a 3-camera, 5-frame synthetic rig on the CPU."""
    rig = mct.make_synthetic_rig(n_cameras=3, n_frames=5, noise_px=0.3, dropout=0.2, seed=37)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    return (as_t(rig.all_calib_uvs), as_t(np.stack([k for k, _ in rig.all_intrinsics])),
            as_t(np.stack([d for _, d in rig.all_intrinsics])), as_t(rig.calib_objpoints))


@pytest.fixture(scope="module")
def problem():
    return _pose_problem("cpu", 4, 6, seed=38)


def test_emulated_pose_kernel_matches_twin(lib, problem):
    """4 cameras x 6 frames x 35 points, undetected frames among them, and a
    frame where the twin keeps branch B (so the planar twin pose counts)."""
    got = pose_cuda._launch(lib, 0, *problem)
    assert got.shape == (4, 6, 6) and got.dtype == torch.float64
    assert bool(problem[3].any()) and not bool(problem[3].all())
    converged, kept_b = _assert_poses_match(got, problem)
    assert converged.sum() >= 10 and kept_b.any()


def test_emulated_pose_kernel_on_a_singular_frame(lib):
    args = _singular_problem("cpu")
    assert bool(tinit.pose_gn_refine_reference(*args).isnan().all())
    assert bool(pose_cuda._launch(lib, 0, *args).isnan().all())


def test_emulated_pose_kernel_on_a_7x10_board(lib):
    """The detector's default 7 x 10 board: 70 points, so lanes 0-5 take a
    third point (n = lane + 64) and the others two; 3 cameras x 4 frames."""
    args = _pose_problem("cpu", 3, 4, seed=39, board_shape=(7, 10))
    assert args[4].shape[0] == 70 and bool(args[3].any())
    converged, _ = _assert_poses_match(pose_cuda._launch(lib, 0, *args), args)
    assert converged.sum() >= 6


def test_emulated_launch_refuses_an_empty_board(lib):
    poses0, cam12, _, mask, _ = _pose_problem("cpu", 1, 2, seed=36)
    uvs, objp = torch.zeros((1, 2, 0, 2)).double(), torch.zeros((0, 3)).double()
    with pytest.raises(RuntimeError, match="pose_gn_kernel launch failed"):
        pose_cuda._launch(lib, 0, poses0, cam12, uvs, mask, objp)


def test_cpu_tensors_take_the_twin_and_count_no_kernel_frames(problem, monkeypatch):
    """On CPU tensors ``initialize._estimate_poses`` chooses the twin,
    launches nothing and counts 0 kernel frames; the wrapper refuses them."""
    frames, launches = "estimate_pose.gn_kernel.frames", "pose_gn_kernel.launches"
    before = (metrics.stage_times.get(launches, 0), metrics.stage_times.get(frames))
    calls, twin = [], tinit.pose_gn_refine_reference
    monkeypatch.setattr(tinit, "pose_gn_refine_reference",
                        lambda *a: calls.append(a) or twin(*a))
    rig_uvs, K, dist, objp = _estimate_poses_inputs()
    got = tinit._estimate_poses(rig_uvs, K, dist, objp)
    assert len(calls) == 1 and got.shape == rig_uvs.shape[:2] + (6,)
    assert metrics.stage_times.get(launches, 0) == before[0]
    assert metrics.stage_times[frames] == (before[1] or 0)
    ref = twin(*calls[0])
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(got.nan_to_num(), ref.nan_to_num())
    with pytest.raises(ValueError, match="CUDA tensors"):
        pose_cuda.pose_gn_refine(*problem)
    assert metrics.stage_times.get(launches, 0) == before[0]


def test_the_card_check_refuses_tensors_off_the_card(problem):
    """The kernel's input check takes CUDA tensors only: CPU and meta
    tensors are refused before anything is built or launched."""
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            pose_cuda._check(*(x.to(dev) for x in problem))
