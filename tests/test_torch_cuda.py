"""The port's CUDA kernels on the card (each test skips without a CUDA device).

Imports neither JAX nor the JAX package, so it also runs on a GPU machine
without JAX. There ``tests/conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernel vs plain twin on the same device tensors, at the kernel-parity
tolerances of tests/test_ba_pallas.py: U/V/W atol 2e-5 * max|.|, gradients
atol 3e-5 * max(1, max|.|), total cost rtol 3e-5, cost fragments rtol 2e-5
atol 1e-7 (both run an f64 chain and f32 contractions, in other orders); the
cost kernel's f64 total against the f64 sum of its own fragments at rtol
1e-12 (one f64 sum in two orders).
The corner kernel rounds every multiply and add as its twin does, in the
same order, so the two are compared bit for bit; detection through it is
compared with the CPU run of the same frames.
The pose kernel against its twin on the same f64 inputs
(``_assert_poses_match``, through ``chip_smoke.compare_poses``).
Undetected frames are NaN in both, and no frame where the twin converged
(RMS < 5 px, |r| < 2 pi, the criterion of
tests/test_torch_initialize.py::test_estimate_pose_matches_jax) is NaN in
the kernel's result. On the converged frames: the same branch of the
planar ambiguity on at least 99% of them, and, where the branch is the same
and the twin's own pose is stable (no entry moves by more than 1e-9 +
1e-9 of itself when the detections or the camera matrix are scaled by 1 +-
1e-15, or, for card tensors, when the twin runs on the CPU, whose products
and factors round in other orders), poses at rtol 1e-9 / atol 1e-9; frames
that are not stable are at most 1% of the converged ones (or one frame).
Both routes run the same f64 steps, but the kernel sums J^T J by warp
shuffles, multiplies by reciprocals and contracts products into FMAs where
the twin's batched products and solves round in their own orders; 10
Gauss-Newton steps contract that rounding on a converged, stable frame to
well below 1e-9 (~1e-14 in the CPU emulation), while a chaotic frame
(the bench rig's 47 camera-frames whose planar Gauss-Newton is chaotic in
the JAX package too, ``pose_unstable`` in data/bench_ba_ref.npz) may
legitimately part, and a diverged frame's Cholesky decides NaN on a matrix
of condition ~1e19, which rounding sways.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import multicam_calibration_tpu_torch as mct
from multicam_calibration_tpu_torch.models import initialize as tinit
from multicam_calibration_tpu_torch.models import lm_core
from multicam_calibration_tpu_torch.models.bundle_adjustment import _params_to_arrays
from multicam_calibration_tpu_torch.ops import ba_cuda, corner_cuda, pose_cuda
from multicam_calibration_tpu_torch.ops.rotation import so3_exp

DETECT_FRAMES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "multicam_calibration_tpu_torch", "data", "detect_frames.npz",
)

RECIPE = dict(
    jac_dtype="float32", block_dtype="float32", grad_dtype="float32",
    cost_dtype="float32",
)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# Rotation vectors at the edges of the so3 formulas' branches: exactly 0,
# theta^2 = 1e-8 (1 -+ 1e-3) on either side of the series switch, theta near pi.
_T = 1e-4  # sqrt(1e-8)
EDGE_ANGLES = (
    (0.0, 0.0, 0.0),
    (_T * np.sqrt(1 - 1e-3), 0.0, 0.0),
    (0.0, _T * np.sqrt(1 + 1e-3), 0.0),
    (0.0, 0.0, np.pi - 1e-6),
    tuple(np.full(3, (np.pi - 1e-3) / np.sqrt(3))),
)


def _problem(device, n_cameras=3, n_frames=23, seed=4, shift=0.0, pad=0,
             edge_angles=False):
    """Perturbed synthetic rig; ``pad`` zero-pose frames with empty masks
    appended; with ``edge_angles`` the cameras and the first frames take the
    rotation vectors of EDGE_ANGLES in turn."""
    rig = mct.make_synthetic_rig(
        n_cameras=n_cameras, n_frames=n_frames, noise_px=0.3, dropout=0.3,
        seed=seed,
    )
    rng = np.random.default_rng(2)
    ext = rig.all_extrinsics + rng.normal(0, 1e-3, rig.all_extrinsics.shape)
    cam = _params_to_arrays(ext, rig.all_intrinsics) + shift
    poses = np.nan_to_num(rig.calib_poses)
    obs = np.nan_to_num(rig.all_calib_uvs)
    mask = ~np.isnan(rig.all_calib_uvs).any(-1)
    if edge_angles:
        poses[: len(EDGE_ANGLES), :3] = EDGE_ANGLES
        # Each camera keeps the board 4 extents in front of it, centred.
        R_p = so3_exp(torch.as_tensor(poses[:, :3])).numpy()
        pw = rig.calib_objpoints @ R_p.transpose(0, 2, 1) + poses[:, None, 3:]
        centre = pw.reshape(-1, 3).mean(0)
        depth = 4 * np.linalg.norm(pw.reshape(-1, 3) - centre, axis=1).max()
        for i in range(n_cameras):
            cam[i, 6:9] = EDGE_ANGLES[i % len(EDGE_ANGLES)]
            R_c = so3_exp(torch.as_tensor(cam[i, 6:9])).numpy()
            cam[i, 9:12] = np.array([0.0, 0.0, depth]) - R_c @ centre
    N = obs.shape[2]
    poses = np.concatenate([poses, np.zeros((pad, 6))])
    obs = np.concatenate([obs, np.zeros((n_cameras, pad, N, 2))], 1)
    mask = np.concatenate([mask, np.zeros((n_cameras, pad, N), bool)], 1)
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    return as_t(cam), as_t(poses), as_t(obs), as_t(mask), as_t(rig.calib_objpoints)


def _pose_problem(device, n_cameras, n_frames, seed, board_shape=(5, 7)):
    """Inputs of ``pose_gn_refine`` for a synthetic rig whose intrinsics
    have drifted (fx, fy by ~0.3%, the principal point by ~2 px, k1, k2 by
    ~1e-3), as mount drift leaves a rolling calibrator's cameras: the
    homography stage of ``initialize._estimate_poses`` on ``device``.
    Returns (poses0, cam12, uvs, mask, objpoints)."""
    rig = mct.make_synthetic_rig(n_cameras=n_cameras, n_frames=n_frames, noise_px=0.3,
                                 dropout=0.2, seed=seed, board_shape=board_shape)
    rng = np.random.default_rng(seed + 1)
    Ks = np.stack([K for K, _ in rig.all_intrinsics])
    ds = np.stack([d for _, d in rig.all_intrinsics])
    Ks[:, [0, 1], [0, 1]] *= 1 + rng.normal(0, 3e-3, (n_cameras, 2))
    Ks[:, :2, 2] += rng.normal(0, 2.0, (n_cameras, 2))
    ds[:, :2] += rng.normal(0, 1e-3, (n_cameras, 2))
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)  # noqa: E731
    uvs, K, dist, objp = as_t(rig.all_calib_uvs), as_t(Ks), as_t(ds), as_t(rig.calib_objpoints)
    mask, poses0 = torch.vmap(tinit._planar_start, in_dims=(0, 0, 0, None))(uvs, K, dist, objp)
    cam12 = torch.vmap(tinit._cam12)(K, dist)
    return poses0.contiguous(), cam12.contiguous(), uvs, mask.contiguous(), objp


def _singular_problem(device):
    """One camera, a frame whose Gauss-Newton normal matrix is singular in
    floating point and a frame with no detections. The four board points
    sit at the origin and the pose puts them at (512, 0, 512): x = 1 and y
    = 0 exactly, so the t_z column of J is minus the t_x column, the
    rotation columns are 0, and with fx / z = 2^20 every product is a power
    of two: J^T J + 1e-8 I rounds to a matrix whose sixth Cholesky pivot is
    exactly 0 (the ridge is below half an ulp of 2^42)."""
    cam12 = torch.zeros((1, 12), dtype=torch.float64)
    cam12[0, :4] = torch.tensor([2.0**29, 2.0**29, 640.0, 512.0])
    poses0 = torch.zeros((1, 2, 6), dtype=torch.float64)
    poses0[0, 0, 3:] = torch.tensor([512.0, 0.0, 512.0])
    uvs = torch.full((1, 2, 4, 2), float("nan"), dtype=torch.float64)
    uvs[0, 0] = torch.tensor([640.0 + 2.0**29 + 0.5, 511.75], dtype=torch.float64)
    mask = torch.tensor([[True, False]])
    objp = torch.zeros((4, 3), dtype=torch.float64)
    return tuple(x.to(device) for x in (poses0, cam12, uvs, mask, objp))


def _assert_poses_match(got, args, min_converged=0.9):
    """``pose_gn_refine``'s result ``got`` (C, F, 6) against its twin on the
    same inputs ``args``, at the tolerances of the module docstring
    (``chip_smoke.compare_poses``, which phase 19 of chip_smoke.py applies to
    a rolling update's own inputs). Prints what it counted; returns the
    masks (C, F) of the frames where the twin converged and of those where
    it kept branch B."""
    import chip_smoke

    counts = chip_smoke.compare_poses(torch, got, args, min_converged)
    print("pose kernel vs twin, camera-frames:", {
        k: v for k, v in counts.items() if k not in ("converged_mask", "kept_b")})
    return counts["converged_mask"], counts["kept_b"]


def _assert_cost_close(got, ref):
    """(fragments, total) of the cost kernel against the twin's."""
    (frags, total), (ref_frags, ref_total) = got, ref
    assert frags.dtype == torch.float32 and total.dtype == torch.float64
    assert frags.shape == ref_frags.shape and total.shape == ()
    np.testing.assert_allclose(
        frags.double().cpu().numpy(), ref_frags.double().cpu().numpy(), rtol=2e-5, atol=1e-7
    )
    np.testing.assert_allclose(float(total), float(frags.double().sum()), rtol=1e-12)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=3e-5)


def _assert_blocks_close(got, ref):
    got = [x.double().cpu().numpy() for x in got]
    ref = [x.double().cpu().numpy() for x in ref]
    for name, a, b in zip(("U", "V", "W"), got[:3], ref[:3]):
        np.testing.assert_allclose(a, b, atol=2e-5 * float(np.abs(b).max()), err_msg=name)
    for name, a, b in zip(("g_cam", "g_pose"), got[3:5], ref[3:5]):
        atol = 3e-5 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)
    np.testing.assert_allclose(got[5].sum(), ref[5].sum(), rtol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("loss_linear", [False, True], ids=["soft_l1", "linear"])
def test_kernels_match_twins(device, loss_linear):
    cam, poses, obs, mask, objp = _problem(device, shift=3e-5)  # F=23: ragged tile
    prepared = ba_cuda.ba_prepare_obs(obs, mask)
    kw = dict(loss_linear=loss_linear)
    launches = ba_cuda.ba_chunk_blocks.launches
    got = ba_cuda.ba_chunk_blocks(cam, poses, *prepared, objp, **kw)
    assert ba_cuda.ba_chunk_blocks.launches == launches + 1
    _assert_blocks_close(got, ba_cuda.ba_chunk_blocks_reference(cam, poses, *prepared, objp, **kw))
    launches = ba_cuda.ba_chunk_cost.launches
    cost = ba_cuda.ba_chunk_cost(cam, poses, *prepared, objp, **kw)
    assert ba_cuda.ba_chunk_cost.launches == launches + 1
    _assert_cost_close(cost, ba_cuda.ba_chunk_cost_reference(cam, poses, *prepared, objp, **kw))
    # No float atomics: a second launch is bit-identical.
    again = ba_cuda.ba_chunk_blocks(cam, poses, *prepared, objp, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for a, b in zip(cost, ba_cuda.ba_chunk_cost(cam, poses, *prepared, objp, **kw)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("loss_linear", [False, True], ids=["soft_l1", "linear"])
@pytest.mark.parametrize(
    "case",
    [dict(n_frames=23, shift=3e-5), dict(n_cameras=2, n_frames=61, seed=9, shift=3e-5, pad=6),
     dict(n_cameras=5, n_frames=23, seed=5, edge_angles=True),
     dict(n_cameras=5, n_frames=61, seed=9, pad=6, edge_angles=True)],
    ids=["ragged23", "padded61+6", "angles23", "angles61+6"],
)
def test_kernels_match_twins_at_edges(device, case, loss_linear):
    """Ragged and zero-pose padded frame counts, and rotation vectors at the
    edges of the in-kernel so3 formulas: kernel vs twin, relaunch bit-identical,
    padded frames exactly 0 in V, W and cost."""
    cam, poses, obs, mask, objp = _problem(device, **case)
    args = (cam, poses, *ba_cuda.ba_prepare_obs(obs, mask), objp)
    kw = dict(loss_linear=loss_linear)
    got = ba_cuda.ba_chunk_blocks(*args, **kw)
    _assert_blocks_close(got, ba_cuda.ba_chunk_blocks_reference(*args, **kw))
    for a, b in zip(got, ba_cuda.ba_chunk_blocks(*args, **kw)):
        assert torch.equal(a, b)
    Fr = poses.shape[0] - case.get("pad", 0)
    for x in (got[1][Fr:], got[2][:, Fr:], got[5][:, Fr:]):
        assert x.numel() == 0 or float(x.abs().max()) == 0.0
    cost = ba_cuda.ba_chunk_cost(*args, **kw)
    _assert_cost_close(cost, ba_cuda.ba_chunk_cost_reference(*args, **kw))
    for a, b in zip(cost, ba_cuda.ba_chunk_cost(*args, **kw)):
        assert torch.equal(a, b)
    assert cost[0][:, Fr:].numel() == 0 or float(cost[0][:, Fr:].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("loss_linear", [False, True], ids=["soft_l1", "linear"])
@pytest.mark.parametrize("case", ["bench", "C64", "C1"])
def test_cost_kernel_matches_twin_at_scale(device, case, loss_linear):
    """The cost kernel at the bench shape (6 x 922 x 35, 396 blocks), on a
    64-camera rig and on one camera: fragments and total against the twin,
    many relaunches bit-identical whichever block arrives last, and the
    fragments equal to the block kernel's."""
    if case == "bench":
        import chip_smoke

        cam, poses, obs, mask, objp = chip_smoke.bench_problem(torch, device)
    else:
        cam, poses, obs, mask, objp = _problem(
            device, n_cameras=64 if case == "C64" else 1, n_frames=30, seed=3
        )
    args = (cam, poses, *ba_cuda.ba_prepare_obs(obs, mask), objp)
    kw = dict(loss_linear=loss_linear)
    cost = ba_cuda.ba_chunk_cost(*args, **kw)
    _assert_cost_close(cost, ba_cuda.ba_chunk_cost_reference(*args, **kw))
    for _ in range(20):
        for a, b in zip(cost, ba_cuda.ba_chunk_cost(*args, **kw)):
            assert torch.equal(a, b)
    block_cost = ba_cuda.ba_chunk_blocks(*args, **kw)[5]
    np.testing.assert_allclose(
        cost[0].cpu().numpy(), block_cost.cpu().numpy(), rtol=1e-6, atol=1e-9
    )


@pytest.mark.cuda
def test_block_build_launches_at_most_two_kernels(device):
    """torch.profiler sees at most two CUDA kernel launches per
    ba_chunk_blocks call and one per ba_chunk_cost call (its total is added
    in the same kernel): the wrappers do no tensor arithmetic of their own
    on the card."""
    from torch.profiler import ProfilerActivity, profile

    cam, poses, obs, mask, objp = _problem(device)
    args = (cam, poses, *ba_cuda.ba_prepare_obs(obs, mask), objp)
    for fn, most in ((ba_cuda.ba_chunk_blocks, 2), (ba_cuda.ba_chunk_cost, 1)):
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn(*args)
            torch.cuda.synchronize()
        n = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
        assert 0 < n <= 3 * most, (fn.__name__, n)


@pytest.mark.cuda
def test_wrappers_take_only_what_the_kernels_read(device):
    """The wrappers convert nothing: f32 or non-contiguous parameters raise;
    lm_solve hands f32 data to the kernels in f64."""
    cam, poses, obs, mask, objp = _problem(device)
    prepared = ba_cuda.ba_prepare_obs(obs, mask)
    for bad in ((cam.float(), poses, objp), (cam, poses.t().contiguous().t(), objp),
                (cam, poses, objp.float())):
        for fn in (ba_cuda.ba_chunk_blocks, ba_cuda.ba_chunk_cost):
            with pytest.raises(ValueError):
                fn(bad[0], bad[1], *prepared, bad[2])
    opts = lm_core.LMOptions(max_iters=3, block_impl="cuda", cost_impl="cuda", **RECIPE)
    before = ba_cuda.ba_chunk_blocks.launches
    _, _, info = lm_core.lm_solve(cam.float(), poses.float(), obs.float(), mask,
                                  objp.float(), opts)
    assert np.isfinite(info["final_cost"])
    assert ba_cuda.ba_chunk_blocks.launches - before == info["n_iters"]


@pytest.mark.cuda
def test_padded_frames_stay_finite(device):
    cam, poses, obs, mask, objp = _problem(device, n_cameras=2, n_frames=70, seed=9, shift=3e-5)
    pad = 6
    poses = torch.cat([poses, poses.new_zeros(pad, 6)])
    obs = torch.cat([obs, obs.new_zeros(2, pad, obs.shape[2], 2)], 1)
    mask = torch.cat([mask, mask.new_zeros(2, pad, mask.shape[2])], 1)
    got = ba_cuda.ba_chunk_blocks(cam, poses, *ba_cuda.ba_prepare_obs(obs, mask), objp)
    for name, x in zip(("U", "V", "W", "g_cam", "g_pose", "cost"), got):
        assert bool(x.isfinite().all()), name
    assert float(got[1][70:].abs().max()) == 0.0
    assert float(got[2][:, 70:].abs().max()) == 0.0


@pytest.mark.cuda
def test_lm_solve_through_kernels_matches_plain(device):
    cam, poses, obs, mask, objp = _problem(device, n_frames=40)
    base = lm_core.LMOptions(
        solve_dtype="float32", lambda_escalation=3.0, max_iters=40, **RECIPE
    )
    # The default routes: both kernels, one block build per iteration and one
    # cost launch per cost evaluation.
    assert base.block_impl == base.cost_impl == "auto"
    before = (ba_cuda.ba_chunk_blocks.launches, ba_cuda.ba_chunk_cost.launches)
    _, _, info_k = lm_core.lm_solve(cam, poses, obs, mask, objp, base)
    assert ba_cuda.ba_chunk_blocks.launches - before[0] == info_k["n_iters"]
    assert ba_cuda.ba_chunk_cost.launches - before[1] == info_k["nfev"]
    before = (ba_cuda.ba_chunk_blocks.launches, ba_cuda.ba_chunk_cost.launches)
    _, _, info_p = lm_core.lm_solve(
        cam, poses, obs, mask, objp,
        dataclasses.replace(base, block_impl="torch", cost_impl="torch"),
    )
    assert (ba_cuda.ba_chunk_blocks.launches, ba_cuda.ba_chunk_cost.launches) == before
    ck, cp = info_k["final_cost"], info_p["final_cost"]
    assert abs(ck - cp) <= 1e-3 * cp, (ck, cp)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [1.5, 2.0, 3.5, 6.0, 9.0])  # 2.0: the runtime radius
@pytest.mark.parametrize("shape", [(3, 130, 131), (2, 480, 640), (1, 37, 300)])
def test_corner_kernel_matches_twin(device, shape, sigma):
    gray = torch.rand(shape, generator=torch.Generator(device=device).manual_seed(1),
                      device=device)
    before = (corner_cuda.corner_response_peaks.launches, corner_cuda.corner_response_fused.launches)
    resp, peak = corner_cuda.corner_response_peaks(gray, sigma, 4)
    resp_f = corner_cuda.corner_response_fused(gray, sigma)
    assert (corner_cuda.corner_response_peaks.launches, corner_cuda.corner_response_fused.launches) \
        == (before[0] + 1, before[1] + 1)
    resp_t, peak_t = corner_cuda.corner_response_peaks_reference(gray, sigma, 4)
    assert peak.dtype == torch.bool and resp.dtype == torch.float32
    assert torch.equal(resp, resp_t) and torch.equal(peak, peak_t)
    assert torch.equal(resp_f, resp_t)
    again, peak2 = corner_cuda.corner_response_peaks(gray, sigma, 4)  # a relaunch: the same bits
    assert torch.equal(again, resp) and torch.equal(peak2, peak)


@pytest.mark.cuda
def test_detection_on_card_matches_cpu(device):
    d = np.load(DETECT_FRAMES)
    pick = [0, 8, 12, 14]  # clean, hard, 12 px and 16 px blur
    frames = list(d["frames"][pick])
    board = tuple(int(v) for v in d["board_shape"])
    before = corner_cuda.corner_response_peaks.launches
    got = mct.detect_chessboard_batch(frames, board_shape=board, device=device)
    assert corner_cuda.corner_response_peaks.launches - before >= 2  # stage 1 + the ladder
    ref = mct.detect_chessboard_batch(frames, board_shape=board, device="cpu")
    assert sorted(got) == sorted(ref) == list(range(len(pick)))
    for i in ref:
        np.testing.assert_allclose(got[i][0], ref[i][0], atol=0.01)
        np.testing.assert_allclose(got[i][1], ref[i][1], atol=1e-3)


@pytest.mark.cuda
def test_chunked_block_build_through_kernel_matches_dense(device):
    """frame_chunk=7 on 23 frames (+2 zero-pose padded frames in the last
    slab): one block-kernel call per slab, blocks equal to the dense kernel
    build at the kernel-parity tolerances."""
    cam, poses, obs, mask, objp = _problem(device, n_frames=23)
    opts = lm_core.LMOptions(**RECIPE)
    before = ba_cuda.ba_chunk_blocks.launches
    dense = lm_core.build_normal_blocks(cam, poses, obs, mask, objp, opts)
    chunked = lm_core.build_normal_blocks(
        cam, poses, obs, mask, objp, dataclasses.replace(opts, frame_chunk=7))
    assert ba_cuda.ba_chunk_blocks.launches - before == 1 + 4
    C, F = cam.shape[0], poses.shape[0]
    as_dense = (chunked.U, chunked.V.reshape(-1, 6, 6)[:F],
                chunked.W.movedim(1, 0).reshape(C, -1, 12, 6)[:, :F], chunked.g_cam,
                chunked.g_pose.reshape(-1, 6)[:F], chunked.cost)
    _assert_blocks_close(as_dense[:5] + (as_dense[5].reshape(1),),
                         tuple(dense[:5]) + (dense.cost.reshape(1),))
    assert float(chunked.V.reshape(-1, 6, 6)[F:].abs().max()) == 0.0


@pytest.mark.cuda
def test_pose_mask_through_kernels_matches_twin(device):
    """The pose-repair solve's route: a pose_free mask on the kernel build
    against the plain twin, and an lm_solve through the kernels that leaves
    every frozen pose exactly where it was."""
    cam, poses, obs, mask, objp = _problem(device, n_frames=23, shift=3e-5)
    F = poses.shape[0]
    pose_free = torch.zeros((F, 6), dtype=torch.float64, device=device)
    pose_free[3::5] = 1.0
    opts = lm_core.LMOptions(solve_dtype="float32", lambda_escalation=3.0, **RECIPE)
    got = lm_core.build_normal_blocks(cam, poses, obs, mask, objp, opts, pose_free=pose_free)
    ref = lm_core.build_normal_blocks(cam, poses, obs, mask, objp,
                                      dataclasses.replace(opts, block_impl="torch"),
                                      pose_free=pose_free)
    _assert_blocks_close(tuple(got[:5]) + (got.cost.reshape(1),),
                         tuple(ref[:5]) + (ref.cost.reshape(1),))
    cam_free = torch.zeros((cam.shape[0], 12), dtype=torch.float64, device=device)
    before = ba_cuda.ba_chunk_blocks.launches
    _, poses2, info = lm_core.lm_solve(cam, poses + 1e-3, obs, mask, objp, opts,
                                       cam_free=cam_free, pose_free=pose_free)
    assert ba_cuda.ba_chunk_blocks.launches - before == info["n_iters"] > 0
    frozen = pose_free[:, 0] == 0
    assert torch.equal(poses2[frozen], (poses + 1e-3)[frozen])
    assert info["final_cost"] < info["initial_cost"]


@pytest.mark.cuda
def test_calibrate_and_bundle_adjust_on_card_match_cpu(device):
    """A small calibrate -> bundle_adjust on the card (the f32 recipe: both
    kernels, the f64 polish) against the same calls on the CPU, the recipe
    given there as lm_options: the same tree and frames, intrinsics rtol
    1e-7, extrinsics atol 1e-5, final cost rtol 1e-5 (the f32 products round
    in other orders on the two routes, so the LM stops at other points of
    its ftol window; 1e-5 is phase 11's bound against the JAX package)."""
    rig = mct.make_synthetic_rig(n_cameras=4, n_frames=60, noise_px=0.2, dropout=0.1, seed=5)
    args = (rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints)
    card = mct.calibrate(*args, verbose=False, n_samples_for_intrinsics=30, device=device)
    cpu = mct.calibrate(*args, verbose=False, n_samples_for_intrinsics=30, device="cpu")
    assert card[3] == cpu[3]
    for (Kg, dg), (Kc, dc) in zip(card[1], cpu[1]):
        np.testing.assert_allclose(Kg, Kc, rtol=1e-7)
        np.testing.assert_allclose(dg, dc, atol=1e-6)
    np.testing.assert_allclose(card[0], cpu[0], atol=1e-5)
    recipe = dict(block_dtype="float32", cost_dtype="float32", solve_dtype="float32",
                  grad_dtype="float32", gtol_rel=1e-6, lambda_escalation=3.0)
    before = (ba_cuda.ba_chunk_blocks.launches, ba_cuda.ba_chunk_cost.launches)
    ba_card = mct.bundle_adjust(rig.all_calib_uvs, card[0], card[1], rig.calib_objpoints,
                                card[2], verbose=False, device=device)
    assert ba_cuda.ba_chunk_blocks.launches > before[0]
    assert ba_cuda.ba_chunk_cost.launches > before[1]
    ba_cpu = mct.bundle_adjust(rig.all_calib_uvs, card[0], card[1], rig.calib_objpoints,
                               card[2], verbose=False, device="cpu", lm_options=recipe)
    np.testing.assert_array_equal(ba_card[3], ba_cpu[3])
    assert not bool(ba_card[4]["polish_on_cpu"]) and int(ba_card[4]["polish_iters"]) >= 1
    np.testing.assert_allclose(float(ba_card[4]["final_cost"]), float(ba_cpu[4]["final_cost"]),
                               rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [1.5, 3.5, 6.0, 9.0])
@pytest.mark.parametrize("shape,nms", [((128, 240, 320), 2), ((128, 160, 213), 2),
                                       ((1, 360, 480), 4)], ids=["f2", "f3", "scale075"])
def test_corner_kernel_matches_twin_at_new_shapes(device, shape, nms, sigma):
    """The low-band path's decimated batches (NMS radius 2, an odd width of
    213) and a scale_factor 0.75 frame: kernel and twin bit for bit."""
    gray = torch.rand(shape, generator=torch.Generator(device=device).manual_seed(2),
                      device=device)
    resp, peak = corner_cuda.corner_response_peaks(gray, sigma, nms)
    resp_t, peak_t = corner_cuda.corner_response_peaks_reference(gray, sigma, nms)
    assert torch.equal(resp, resp_t) and torch.equal(peak, peak_t)


@pytest.mark.cuda
def test_low_band_and_scaled_detection_on_card_match_cpu(device):
    d = np.load(DETECT_FRAMES)
    frames = list(d["frames"][[0, 8, 12, 14]])
    board = tuple(int(v) for v in d["board_shape"])
    for kw in ({"coarse_downscale": 2}, {"coarse_downscale": 3}, {"scale_factor": 0.75}):
        got = mct.detect_chessboard_batch(frames, board_shape=board, device=device, **kw)
        ref = mct.detect_chessboard_batch(frames, board_shape=board, device="cpu", **kw)
        assert sorted(got) == sorted(ref), kw
        for i in ref:
            np.testing.assert_allclose(got[i][0], ref[i][0], atol=0.01)
            np.testing.assert_allclose(got[i][1], ref[i][1], atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 2])
def test_streamed_batches_on_card_equal_sequential_calls(device, f):
    """Pinned uploads and one CUDA stream per batch in flight change no
    arithmetic: every dict bit-equal to a sequential call; the caller's
    stream is current again between results."""
    d = np.load(DETECT_FRAMES)
    board = tuple(int(v) for v in d["board_shape"])
    frames = list(d["frames"])
    batches = [frames[:6], [], frames[6:12], frames[12:]]
    caller = torch.cuda.current_stream(device)
    streamed = []
    for out in mct.detect_chessboard_batches(batches, board_shape=board, coarse_downscale=f,
                                             device=device):
        assert torch.cuda.current_stream(device) == caller
        streamed.append(out)
    assert len(streamed) == len(batches) and streamed[1] == {}
    for got, images in zip(streamed, batches):
        want = mct.detect_chessboard_batch(images, board_shape=board, coarse_downscale=f,
                                           device=device) if images else {}
        assert sorted(got) == sorted(want)
        for i in want:
            assert np.array_equal(got[i][0], want[i][0]) and np.array_equal(got[i][1], want[i][1])


@pytest.mark.cuda
def test_native_lattice_builds_and_matches_numpy(device):
    """csrc/lattice.cc builds with the host compiler on the card's machine
    and grows the stored candidates' lattices as the numpy twin does."""
    from multicam_calibration_tpu_torch.detection import detector, native_lattice

    built = native_lattice.library()
    assert built.path.exists() and "lattice.cc" in built.log
    d = np.load(DETECT_FRAMES)
    for p, s in zip(d["cand_xy"].astype(float), d["cand_score"].astype(float)):
        rn = native_lattice.grow_lattice(p, s, 35, 0.35)
        rp = detector._grow_lattice_numpy(p, s, 35, 0.35)
        assert np.array_equal(rn[0], rp[0]) and (rn[3] is None) == (rp[3] is None)
        if rn[3] is not None:
            assert set(rn[3].values()) == set(rp[3].values())


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 2])
def test_streamed_dispatch_does_not_synchronise(device, f, monkeypatch):
    """After a warm-up (the anchor stage's constant tensors are copied to the
    card once), no streamed dispatch calls a synchronising CUDA operation.
    The low band's escalation dispatches inside a host half, which reads
    back anyway, and is not held to it."""
    from multicam_calibration_tpu_torch.detection import detector

    d = np.load(DETECT_FRAMES)
    board = tuple(int(v) for v in d["board_shape"])
    batches = [list(d["frames"][:8]), list(d["frames"][8:])]
    list(mct.detect_chessboard_batches(batches, board_shape=board, coarse_downscale=f,
                                       device=device))
    dispatch = detector._BatchOptions.dispatch

    def strict(self, images, stage=None):
        if stage is None:  # the host half's own calls (the low band's escalation)
            return dispatch(self, images, stage)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(self, images, stage)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(detector._BatchOptions, "dispatch", strict)
    out = list(mct.detect_chessboard_batches(batches, board_shape=board, coarse_downscale=f,
                                             device=device))
    assert [len(o) for o in out] == [8, 8]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["triangulate", "calibration_uncertainty", "flatibrate"])
def test_analysis_on_card_matches_cpu(device, entry):
    """The analysis entry points in f64 on the card against the port's own
    CPU run of the same inputs, NaN in the same places: triangulate rtol
    1e-9 (atol 1e-9 mm), the flatibration transform atol 1e-12, and
    calibration_uncertainty rtol 1e-8. The standard errors are conditioned
    so that rounding alone moves them by ~1e-9 on this rig: on the CPU,
    poses scaled by 1 + 1e-15 move camera_sd by 5.5e-10 relative, and the
    card, summing in other orders, differed from the CPU by 2.5e-9 (1e-8 is
    also the tolerance against the JAX package)."""
    rig = mct.make_synthetic_rig(n_cameras=4, n_frames=24, noise_px=0.3, dropout=0.2, seed=9)
    ext, intr = rig.all_extrinsics, rig.all_intrinsics
    if entry == "triangulate":
        views = list(rig.all_calib_uvs.reshape(4, -1, 2))

        def run(dev):
            med = mct.triangulate(views, list(ext), intr, refine=False, device=dev)
            pts, sd = mct.triangulate(views, list(ext), intr, return_sd=True, device=dev)
            return [x.cpu().numpy() for x in (med, pts, sd)]
        tol = dict(rtol=1e-9, atol=1e-9)
    elif entry == "calibration_uncertainty":
        def run(dev):
            out = mct.calibration_uncertainty(rig.all_calib_uvs, ext, intr, rig.calib_objpoints,
                                              rig.calib_poses, device=dev)
            return [out["camera_sd"], out["pose_sd"], np.array(out["sigma_px"])]
        tol = dict(rtol=1e-8, atol=0)
    else:
        rng = np.random.default_rng(5)
        pts = np.column_stack([rng.uniform(-300, 300, (400, 2)), rng.normal(30, 1, 400)])
        pts[:40, 2] += 100.0

        def run(dev):
            return [mct.flatibrate(pts, device=dev)]
        tol = dict(rtol=0, atol=1e-12)
    for card, cpu in zip(run(device), run("cpu")):
        np.testing.assert_allclose(card, cpu, equal_nan=True, **tol)


@pytest.mark.cuda
def test_rolling_update_on_card_launches_both_kernels(device, monkeypatch):
    """A small RollingCalibrator on the card takes the f32 recipe: each update
    launches ba_blocks_kernel n_iters times and ba_cost_kernel nfev times."""
    from multicam_calibration_tpu_torch.models import streaming

    rig = mct.make_synthetic_rig(n_cameras=4, n_frames=24, noise_px=0.3, dropout=0.15, seed=21)
    infos = []
    lm_solve = streaming.lm_solve
    monkeypatch.setattr(streaming, "lm_solve",
                        lambda *a, **k: infos.append(lm_solve(*a, **k)) or infos[-1])
    cal = mct.RollingCalibrator(rig.all_extrinsics, rig.all_intrinsics, rig.calib_objpoints,
                                window=16, device=device)
    assert cal._opts.block_dtype == "float32" and cal._opts.lambda_escalation == 3.0
    for lo in range(0, 24, 6):
        before = (ba_cuda.ba_chunk_blocks.launches, ba_cuda.ba_chunk_cost.launches)
        info = cal.update(rig.all_calib_uvs[:, lo:lo + 6])
        solve = infos[-1][2]
        assert ba_cuda.ba_chunk_blocks.launches - before[0] == solve["n_iters"] == info["n_iters"]
        assert ba_cuda.ba_chunk_cost.launches - before[1] == solve["nfev"]
        assert np.isfinite(info["cost"])
    assert cal.occupancy == 16


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rolling", "calibrate_slab", "board_7x10"])
def test_pose_kernel_matches_twin(device, case):
    """pose_gn_kernel against its twin at the rolling update's slab (64
    cameras x 8 frames x 35 points), at a calibrate slab (16 x 1,024) and
    on the detector's default 7 x 10 board (70 points, 3 a lane for the
    first 6 lanes; 64 x 8): one launch each."""
    C, F, seed, board = {"rolling": (64, 8, 31, (5, 7)), "calibrate_slab": (16, 1024, 32, (5, 7)),
                         "board_7x10": (64, 8, 35, (7, 10))}[case]
    args = _pose_problem(device, C, F, seed=seed, board_shape=board)
    assert args[4].shape[0] == board[0] * board[1]
    before = pose_cuda.pose_gn_refine.launches
    got = pose_cuda.pose_gn_refine(*args)
    assert pose_cuda.pose_gn_refine.launches == before + 1
    assert got.shape == (C, F, 6) and got.device == args[0].device
    _assert_poses_match(got, args)
    again = pose_cuda.pose_gn_refine(*args)  # no float atomics: the same bits
    assert torch.equal(again.isnan(), got.isnan())
    assert torch.equal(again.nan_to_num(), got.nan_to_num())


@pytest.mark.cuda
def test_pose_kernel_on_a_singular_frame(device):
    """A frame whose normal matrix is not positive definite comes out NaN, as
    the twin's Cholesky makes it; an undetected frame is NaN."""
    args = _singular_problem(device)
    got = pose_cuda.pose_gn_refine(*args)
    ref = pose_cuda.pose_gn_refine_reference(*args)
    assert bool(ref.isnan().all()) and bool(got.isnan().all())


@pytest.mark.cuda
def test_pose_stage_launches_once_per_slab(device, monkeypatch):
    """_batched_estimate_pose on the card: one pose_gn_kernel launch per
    slab of POSE_BATCH camera-frames, the counter estimate_pose.gn_kernel.frames
    raised by the slab's camera-frames, and each slab's poses those of the
    twin on the slab's inputs."""
    from multicam_calibration_tpu_torch.utils.metrics import metrics

    rig = mct.make_synthetic_rig(n_cameras=8, n_frames=24, noise_px=0.3, dropout=0.2, seed=33)
    uvs = torch.as_tensor(rig.all_calib_uvs, device=device)
    K = torch.as_tensor(np.stack([k for k, _ in rig.all_intrinsics]), device=device)
    dist = torch.as_tensor(np.stack([d for _, d in rig.all_intrinsics]), device=device)
    objp = torch.as_tensor(rig.calib_objpoints, device=device)
    slabs = []
    real = tinit.pose_gn_refine
    monkeypatch.setattr(tinit, "pose_gn_refine",
                        lambda *a: slabs.append((a, real(*a))) or slabs[-1][1])
    monkeypatch.setattr(tinit, "POSE_BATCH", 8 * 10)  # slabs of 10, 10 and 4 frames
    before = (pose_cuda.pose_gn_refine.launches,
              metrics.stage_times.get(pose_cuda.COUNTER, 0))
    got = tinit._batched_estimate_pose(uvs, K, dist, objp)
    assert pose_cuda.pose_gn_refine.launches == before[0] + 3
    assert metrics.stage_times[pose_cuda.COUNTER] == before[1] + 8 * 24
    assert [a[2].shape[1] for a, _ in slabs] == [10, 10, 4]
    assert torch.equal(got.isnan(), torch.cat([out for _, out in slabs], 1).isnan())
    for args, out in slabs:
        _assert_poses_match(out, args)


@pytest.mark.cuda
def test_pose_wrapper_takes_only_what_the_kernel_reads(device):
    args = _pose_problem(device, 2, 3, seed=34)
    bad = {
        "float32 uvs": (args[0], args[1], args[2].float(), args[3], args[4]),
        "float mask": (*args[:3], args[3].double(), args[4]),
        "strided poses": (args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:]),
        "cpu cameras": (args[0], args[1].cpu(), *args[2:]),
        "no points": (*args[:2], torch.zeros((2, 3, 0, 2), dtype=torch.float64, device=device),
                      args[3], torch.zeros((0, 3), dtype=torch.float64, device=device)),
    }
    for bad_args in bad.values():
        with pytest.raises(ValueError):
            pose_cuda.pose_gn_refine(*bad_args)


BENCH_CELLS = ("rig6.detect_mixed", "stage64.rolling", "stage64.ba", "stage64.calib")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_benchmark_cell_is_correct_on_card(device, cell):
    """A sound run of each benchmark cell at its tiny size on the card: the
    route the CPU suite cannot take (the float32 recipe through both BA
    kernels, ``pose_gn_kernel``, the camera-batched ``calibrate``) is held
    to the cell's own reference and limits."""
    from perfbench.harness import core
    from perfbench.tests.test_perfbench_calib import TINY_CALIB
    from perfbench.tests.tiny import tiny

    overrides = TINY_CALIB if cell == "stage64.calib" else tiny(cell)
    r = core.run_cell(cell, 2**31 + 4321, 0.5, 0, device, overrides=overrides)
    assert r["correct"] is True, r["checks"]
