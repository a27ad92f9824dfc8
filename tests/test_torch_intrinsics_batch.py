"""The camera-batched intrinsics stage of the port vs the JAX package's, and
the lockstep lane LM (``lm_core._lm_solve_lanes``) vs a loop of
``lm_solve``, and the frame slabs of the batched pose stage.

f64 on the CPU, on the rig of tests/test_torch_initialize.py (4 cameras x 60
frames, noise 0.2 px, dropout 0.1, seed 5) with 30 intrinsics samples per
camera. Its camera 2 is flagged by the basin guard: Zhang's K puts its
principal point 0.14 of the image diagonal off the fixed-principal-point
start. Tolerances:

- one lane alone vs ``lm_solve``, each of the four problems under the
  default options: the same counts, and parameters, final cost and first
  gradient norm within rtol 1e-10 (measured bit-equal under every option
  set of the test at 1-8 BLAS threads but for <= 2.9e-13 at some): the
  lanes' code reduced to B = 1 is ``lm_solve``;
- four lanes vs a loop of ``lm_solve``: the same formulas, but batched
  GEMMs over four lanes round the normal blocks differently (~1e-17
  relative) and each solve amplifies that along its least-determined
  directions (focal length against board distance), by as much as
  ``lm_solve`` itself moves when the detections are scaled by 1 +- 1e-15.
  Equal ``n_iters``, ``nfev``, ``converged`` and tries per iteration; final
  costs and first gradient norms within rtol 1e-10 (measured <= 1.7e-11).
  A lane that converged: its cost history within 1e-10 (measured <=
  4.4e-11), its parameters and lambda within 3e-9 (measured <= 6.8e-10 in
  an element of camera or poses). A lane that runs to ``max_iters``
  unconverged (camera 2 from Zhang's K, in the flat half-focal valley the
  basin guard exists for) amplifies the roundings over its 60 iterations:
  cost history, parameters and lambda within 2e-7 (measured <= 4.7e-8).
  Measured at 1-8 BLAS threads. Zeros within 1e-13 of the largest entry;
- a lane that starts from a non-finite K: the other lanes bit-equal to the
  same solve without it;
- ``_batched_zhang_init`` vs JAX's: rtol 1e-9 (closed forms through other
  LAPACK calls and sum orders);
- ``_batched_intrinsics_refine`` and ``get_intrinsics_batch`` vs JAX's:
  rtol 1e-7 on (fx, fy, cx, cy) and final costs, atol 1e-6 on (k1, k2), the
  iterated-solve tolerances of tests/test_torch_initialize.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import multicam_calibration_tpu as jmct
from multicam_calibration_tpu.models import initialize as ji
from multicam_calibration_tpu.models import lm_core as jlm
from multicam_calibration_tpu_torch.models import initialize as ti
from multicam_calibration_tpu_torch.models import lm_core as tlm

N_SAMPLES = 30
OPTS = dict(max_iters=60, ftol=1e-6, loss="linear")  # get_intrinsics' options
FLAGGED = [False, False, True, False]


@pytest.fixture(scope="module")
def rig():
    return jmct.make_synthetic_rig(n_cameras=4, n_frames=60, noise_px=0.2, dropout=0.1, seed=5)


@pytest.fixture(scope="module")
def stage(rig):
    """get_intrinsics_batch's inputs: padded samples (C, S, N, 2), frame
    mask (C, S), board points, image sizes (C, 2), as numpy."""
    samples = [ti._sample_frames(rig.all_calib_uvs[c], N_SAMPLES, 0) for c in range(4)]
    uvs = np.nan_to_num(np.stack([rig.all_calib_uvs[c, s] for c, (s, _) in enumerate(samples)]))
    mask = np.arange(N_SAMPLES)[None] < np.array([take for _, take in samples])[:, None]
    return uvs, mask, rig.calib_objpoints, np.asarray(rig.img_sizes, float)


@pytest.fixture(scope="module")
def jax_zhang(stage):
    return tuple(np.asarray(x) for x in ji._batched_zhang_init(*(jnp.asarray(x) for x in stage)))


def _t(*xs):
    return tuple(torch.as_tensor(np.array(x)) for x in xs)


@pytest.fixture(scope="module")
def problems(stage, jax_zhang):
    """Each camera's intrinsics problem from its Zhang K, as lm_solve takes
    it: (cam0 (1, 12), poses0 (S, 6), obs (1, S, N, 2), mask (1, S, N))."""
    uvs, mask, objp, _ = _t(*stage)
    Hs, K0, _ = _t(*jax_zhang)
    out = []
    for c in range(4):
        K = K0[c]
        cam0 = torch.cat([torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
                          torch.zeros(8, dtype=torch.float64)])[None]
        poses0 = ti.poses_from_homographies(Hs[c], K)
        obs = uvs[c][None]
        out.append((cam0, poses0, obs, mask[c][None, :, None].expand(obs.shape[:3])))
    return out, objp


CAM_FREE = torch.cat([torch.ones(6), torch.zeros(6)]).double()[None]


def _stack(problems):
    return tuple(torch.stack(x) for x in zip(*problems))


def _close(got, ref, rtol):
    """Within rtol, zeros within 1e-13 of the largest entry."""
    ref = ref.numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=1e-13 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("variant", ["classic", "nielsen_soft_l1", "jacfwd_escalation",
                                     "pose_free"])
def test_lanes_match_lm_solve_loop(problems, variant):
    """Each lane takes its own solve's steps; the lanes' iteration counts
    differ, so finished lanes are held while others run. Under the default
    options, one lane alone takes exactly lm_solve's steps."""
    probs, objp = problems
    opts, pose_free = tlm.LMOptions(**OPTS), None
    if variant == "nielsen_soft_l1":
        opts = dataclasses.replace(opts, damping_schedule="nielsen", loss="soft_l1")
    elif variant == "jacfwd_escalation":
        opts = dataclasses.replace(opts, jacobian="jacfwd", lambda_escalation=3.0,
                                   gtol_rel=1e-6, max_tries=4, ftol_patience=3)
    elif variant == "pose_free":
        pose_free = torch.ones(N_SAMPLES, 6, dtype=torch.float64)
        pose_free[:3, 3:] = 0.0
    cam, poses, info = tlm._lm_solve_lanes(*_stack(probs), objp, opts, cam_free=CAM_FREE,
                                           pose_free=pose_free)
    seq = [tlm.lm_solve(*p, objp, opts, cam_free=CAM_FREE, pose_free=pose_free)
           for p in probs]
    for p, (c, q, i) in zip(probs, seq if variant == "classic" else []):
        c1, q1, i1 = tlm._lm_solve_lanes(*_stack([p]), objp, opts, cam_free=CAM_FREE,
                                         pose_free=pose_free)
        assert (int(i1["n_iters"][0]), int(i1["nfev"][0])) == (i["n_iters"], i["nfev"])
        _close(c1[0], c, 1e-10)
        _close(q1[0], q, 1e-10)
        _close(i1["final_cost"][0], torch.tensor(i["final_cost"], dtype=torch.float64), 1e-10)
        _close(i1["grad0"][0], torch.tensor(i["grad0"], dtype=torch.float64), 1e-10)
    n_iters = [s[2]["n_iters"] for s in seq]
    assert info["n_iters"].tolist() == n_iters and len(set(n_iters)) > 1
    assert info["nfev"].tolist() == [s[2]["nfev"] for s in seq]
    assert info["converged"].tolist() == [s[2]["converged"] for s in seq]
    # One read per lockstep try: sum over iterations of the most tries a lane took.
    tries = info["history"][..., 4]
    assert info["host_reads"] == int(tries.max(0).values[: max(n_iters)].clamp(min=1).sum())
    for b, (c, p, i) in enumerate(seq):
        assert torch.equal(tries[b], i["history"][:, 4])
        _close(info["final_cost"][b], torch.tensor(i["final_cost"], dtype=torch.float64), 1e-10)
        _close(info["grad0"][b], torch.tensor(i["grad0"], dtype=torch.float64), 1e-10)
        rtol = 3e-9 if i["converged"] else 2e-7
        _close(info["history"][b, :, 0], i["history"][:, 0], 1e-10 if i["converged"] else rtol)
        _close(cam[b], c, rtol)
        _close(poses[b], p, rtol)
        _close(info["lambda"][b], torch.tensor(i["lambda"], dtype=torch.float64), rtol)
        # The last gradient norm is a cancellation residue: its scale is grad0's.
        assert abs(float(info["optimality"][b]) - i["optimality"]) <= rtol * i["grad0"]
        if variant == "pose_free":
            assert torch.equal(p[:3, 3:], probs[b][1][:3, 3:])
            assert torch.equal(poses[b, :3, 3:], probs[b][1][:3, 3:])


def test_nonfinite_lane_is_rejected_alone(problems):
    """A lane from a NaN focal length exhausts its tries (lambda to its
    ceiling) as lm_solve does on it; the others equal the solve without it
    bit for bit."""
    probs, objp = problems
    opts = tlm.LMOptions(**OPTS)
    bad = (probs[2][0].clone(), *probs[2][1:])
    bad[0][0, 0] = float("nan")
    with_bad = [probs[0], bad, probs[1], probs[3]]
    cam, poses, info = tlm._lm_solve_lanes(*_stack(with_bad), objp, opts, cam_free=CAM_FREE)
    cam_r, poses_r, info_r = tlm._lm_solve_lanes(*_stack([probs[0], probs[1], probs[3]]),
                                                 objp, opts, cam_free=CAM_FREE)
    keep = [0, 2, 3]
    assert torch.equal(cam[keep], cam_r) and torch.equal(poses[keep], poses_r)
    for key, v in info.items():
        if key != "host_reads":
            assert torch.equal(v[keep], info_r[key]), key
    _, _, one = tlm.lm_solve(*bad, objp, opts, cam_free=CAM_FREE)
    assert (int(info["n_iters"][1]), int(info["nfev"][1])) == (one["n_iters"], one["nfev"])
    assert bool(info["converged"][1]) and float(info["lambda"][1]) == opts.max_lambda
    assert not torch.isfinite(info["final_cost"][1])
    assert torch.equal(cam[1].nan_to_num(), bad[0].nan_to_num())


def test_batched_zhang_init_matches_jax(stage, jax_zhang):
    got = ti._batched_zhang_init(*_t(*stage))
    for a, b in zip(got, jax_zhang):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-9 * np.abs(b).max())
    _, K0, K0_pp = jax_zhang
    assert ti._basin_guard(K0, K0_pp, stage[3]).tolist() == FLAGGED


def _assert_cams_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got[:, :4], ref[:, :4], rtol=1e-7)
    np.testing.assert_allclose(got[:, 4:6], ref[:, 4:6], atol=1e-6)
    np.testing.assert_array_equal(got[:, 6:], 0.0)


@pytest.mark.parametrize("start", ["zhang", "fixed_pp"])
def test_batched_intrinsics_refine_matches_jax(stage, jax_zhang, start):
    Hs, K0, K0_pp = jax_zhang
    K = K0 if start == "zhang" else K0_pp
    cam_j, cost_j = ji._batched_intrinsics_refine(
        jnp.asarray(K), jnp.asarray(Hs), *(jnp.asarray(x) for x in stage[:3]),
        jlm.LMOptions(**OPTS))
    cam_t, cost_t = ti._batched_intrinsics_refine(*_t(K, Hs, *stage[:3]), tlm.LMOptions(**OPTS))
    assert cam_t.shape == (4, 12) and cost_t.shape == (4,)
    _assert_cams_close(cam_t, cam_j)
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_j), rtol=1e-7)


def test_get_intrinsics_batch_flagged_camera_matches_jax(rig, monkeypatch):
    """Camera 2 is flagged, its fixed-principal-point solve is field-valid
    and cheaper, so both packages keep it; the others keep Zhang's."""
    refines = []
    real = ti._batched_intrinsics_refine

    def record(*args):
        out = real(*args)
        refines.append(out[0])
        return out

    monkeypatch.setattr(ti, "_batched_intrinsics_refine", record)
    args = (rig.all_calib_uvs, rig.calib_objpoints, rig.img_sizes)
    got = ti.get_intrinsics_batch(*args, n_samples=N_SAMPLES, device="cpu")
    ref = ji.get_intrinsics_batch(*args, n_samples=N_SAMPLES)
    for (Kt, dt), (Kj, dj) in zip(got, ref):
        np.testing.assert_allclose(Kt, Kj, rtol=1e-7)
        np.testing.assert_allclose(dt, dj, atol=1e-6)
    # The refine from Zhang's K, then the one from the fixed-pp K.
    assert len(refines) == 2
    for cam, cameras in zip(refines, ([0, 1, 3], [2])):
        for c in cameras:
            np.testing.assert_array_equal(got[c][0][[0, 1, 0, 1], [0, 1, 2, 2]], cam[c, :4])


@pytest.mark.parametrize("option", [dict(block_impl="cuda"), dict(cost_impl="cuda"),
                                    dict(frame_chunk=8), "axis_name"])
def test_lanes_refuse_other_routes(problems, option):
    """The BA kernels, the chunked layout and frame sharding take one
    problem: the lanes raise, naming the option, instead of another route."""
    probs, objp = problems
    if option == "axis_name":
        kwargs, name = dict(axis_name=object()), "axis_name"
        opts = tlm.LMOptions(**OPTS)
    else:
        kwargs, (name,) = {}, option
        opts = tlm.LMOptions(**OPTS, **option)
    with pytest.raises(ValueError, match=name):
        tlm._lm_solve_lanes(*_stack(probs[:2]), objp, opts, **kwargs)


def test_lanes_pin_tf32_off(problems, monkeypatch):
    """TF32 is off inside the lanes solver (its cost evaluations see it) and
    the caller's setting comes back after."""
    probs, objp = problems
    seen = set()
    real = tlm._cost

    def probe(*args):
        seen.add((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                  torch.get_float32_matmul_precision()))
        return real(*args)

    monkeypatch.setattr(tlm, "_cost", probe)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        tlm._lm_solve_lanes(*_stack(probs[:2]), objp, tlm.LMOptions(**{**OPTS, "max_iters": 2}),
                            cam_free=CAM_FREE)
        assert seen == {(False, False, "highest")}
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def test_batched_estimate_pose_in_frame_slabs(rig, monkeypatch):
    """calibrate's batched pose stage splits the frames so no batched eigh
    sees POSE_BATCH camera-frames or more; every slab's poses are those of
    the call in one piece (each frame's pose is its own)."""
    uvs = torch.as_tensor(rig.all_calib_uvs)
    K = torch.as_tensor(np.stack([k for k, _ in rig.all_intrinsics]))
    dist = torch.as_tensor(np.stack([d for _, d in rig.all_intrinsics]))
    objp = torch.as_tensor(rig.calib_objpoints)
    whole = ti._batched_estimate_pose(uvs, K, dist, objp)
    batches = []
    real = torch.linalg.eigh
    monkeypatch.setattr(torch.linalg, "eigh", lambda M: batches.append(M.shape) or real(M))
    monkeypatch.setattr(ti, "POSE_BATCH", 100)  # 4 cameras: slabs of 25 frames
    slabs = ti._batched_estimate_pose(uvs, K, dist, objp)
    assert len(batches) == 3 and all(shape[0] <= 25 for shape in batches)
    np.testing.assert_array_equal(np.isnan(slabs.numpy()), np.isnan(whole.numpy()))
    assert torch.equal(slabs.nan_to_num(), whole.nan_to_num())
