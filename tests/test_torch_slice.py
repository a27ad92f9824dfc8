"""The ported slice as a whole: Schur-LM bundle adjustment, PyTorch vs JAX.

- ``lm_solve`` against the JAX ``lm_solve`` on ``__graft_entry__._tiny_problem``
  (3 x 16 x 35, perturbed start). In f64 both run the same arithmetic, so
  the trajectories coincide: the same ``n_iters`` and ``nfev``, and the
  history cost column at rtol 1e-8. Under the bench's mixed f32 recipe the
  f32 products round differently, so only the optimum is compared: final
  cost within 1e-4 relative, reprojection RMSE within 1e-3 px.
- The bench problem (6 x 922 x 35) solved by the port's plain path on the
  CPU reaches scipy TRF's final cost, 12338.04 (BASELINE_MEASURED.json).
- The numpy inputs the port shares with the JAX package: synthetic rig,
  the exported bench start, the parameter carry-over.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
import multicam_calibration_tpu as jmct
from multicam_calibration_tpu.models import bundle_adjustment as jba
from multicam_calibration_tpu.models import lm_core as jlm
import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu_torch import convert
from multicam_calibration_tpu_torch.models import bundle_adjustment as tba
from multicam_calibration_tpu_torch.models import lm_core as tlm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_X0 = os.path.join(ROOT, "multicam_calibration_tpu_torch", "data", "bench_x0.npz")
SCIPY_TRF_COST = 12338.04  # BASELINE_MEASURED.json, the bench's quality gate
# bench.py:126-137
BENCH_OPTS = dict(
    jac_dtype="float32", block_dtype="float32", cost_dtype="float32",
    solve_dtype="float32", lambda_escalation=3.0, grad_dtype="float32",
    gtol_rel=1e-6,
)


@pytest.fixture(scope="module")
def tiny():
    cam, poses, obs, mask, objp = (
        np.array(x) for x in __graft_entry__._tiny_problem(dtype=jnp.float64)
    )
    rng = np.random.default_rng(11)
    cam = cam + rng.normal(0, 2e-3, cam.shape) * np.r_[[100.0] * 4, [1.0] * 8]
    poses = poses + rng.normal(0, 2e-3, poses.shape)
    return cam, poses, obs, mask, objp


def _solve_both(problem, jopts, extra_np=None, **scalars):
    extra_np = extra_np or {}
    jx = jlm.lm_solve(
        *(jnp.asarray(x) for x in problem), jopts,
        **{k: jnp.asarray(v) for k, v in extra_np.items()}, **scalars,
    )
    tx = tlm.lm_solve(
        *(torch.as_tensor(x) for x in problem),
        convert.lm_options_from_jax(dataclasses.asdict(jopts)),
        **{k: torch.as_tensor(v) for k, v in extra_np.items()}, **scalars,
    )
    return jx, tx


@pytest.mark.parametrize(
    "case",
    ["default", "nielsen_escalation", "freezes_resume"],
)
def test_lm_solve_f64_trajectory_matches_jax(tiny, case):
    extra, scalars = {}, {}
    if case == "default":
        jopts = jlm.LMOptions()
    elif case == "nielsen_escalation":
        jopts = jlm.LMOptions(
            damping_schedule="nielsen", lambda_escalation=2.0, ftol_patience=3,
            init_lambda=10.0, gtol_rel=1e-7,
        )
    else:
        jopts = jlm.LMOptions(max_iters=8, ftol=1e-6)
        cam_free = np.ones(tiny[0].shape)
        cam_free[0, 6:] = 0.0
        pose_free = np.ones(tiny[1].shape)
        pose_free[5] = 0.0
        extra = dict(cam_free=cam_free, pose_free=pose_free)
        scalars = dict(init_lam=3e-3, init_grad0=1e6)
    (cj, pj, ij), (ct, pt, it) = _solve_both(tiny, jopts, extra, **scalars)
    n = int(ij["n_iters"])
    assert n >= 3
    assert it["n_iters"] == n
    assert it["nfev"] == int(ij["nfev"])
    assert it["converged"] == bool(ij["converged"])
    hist_j = np.asarray(ij["history"])
    hist_t = it["history"].numpy()
    assert hist_t.shape == hist_j.shape
    np.testing.assert_allclose(hist_t[:n, 0], hist_j[:n, 0], rtol=1e-8)
    np.testing.assert_array_equal(hist_t[:n, 4], hist_j[:n, 4])  # tries
    np.testing.assert_allclose(it["final_cost"], float(ij["final_cost"]), rtol=1e-8)
    np.testing.assert_allclose(it["initial_cost"], float(ij["initial_cost"]), rtol=1e-12)
    np.testing.assert_allclose(it["lambda"], float(ij["lambda"]), rtol=1e-8)
    if case == "freezes_resume":
        np.testing.assert_array_equal(ct[0, 6:].numpy(), tiny[0][0, 6:])
        np.testing.assert_array_equal(pt[5].numpy(), tiny[1][5])
        assert it["grad0"] == 1e6


def _rmse(residuals, mask):
    """Reprojection RMSE over observed points (px), bench.py's definition."""
    r2 = (np.asarray(residuals) ** 2).sum()
    return float(np.sqrt(r2 / mask.sum()))


def test_lm_solve_bench_recipe_matches_jax(tiny):
    (cj, pj, ij), (ct, pt, it) = _solve_both(tiny, jlm.LMOptions(**BENCH_OPTS))
    np.testing.assert_allclose(it["final_cost"], float(ij["final_cost"]), rtol=1e-4)
    obs, mask, objp = tiny[2:]
    rmse_j = _rmse(jlm.compute_residuals(cj, pj, *(jnp.asarray(x) for x in tiny[2:])), mask)
    rmse_t = _rmse(tlm.compute_residuals(ct, pt, *(torch.as_tensor(x) for x in tiny[2:])), mask)
    assert abs(rmse_t - rmse_j) < 1e-3, (rmse_t, rmse_j)


def test_bench_problem_reaches_scipy_cost():
    """The port's plain path on the full bench problem (6 cameras x 922
    frames, the bench's x0 and options) reaches scipy TRF's final cost."""
    x0 = np.load(BENCH_X0)
    rig = tmct.make_synthetic_rig(
        n_cameras=6, n_frames=1000, noise_px=0.3, dropout=0.25, seed=11
    )
    obs_np = rig.all_calib_uvs[:, x0["use_frames"]]
    mask = torch.as_tensor(~np.isnan(obs_np).any(-1))
    obs = torch.as_tensor(np.nan_to_num(obs_np))
    objp = torch.as_tensor(rig.calib_objpoints)
    opts = tlm.LMOptions(**BENCH_OPTS)
    cam, poses, info = tlm.lm_solve(
        torch.as_tensor(x0["cam0"]), torch.as_tensor(x0["poses0"]), obs, mask,
        objp, opts,
    )
    final = float(tlm.compute_cost(cam, poses, obs, mask, objp, opts))
    assert final <= SCIPY_TRF_COST, final
    assert np.isfinite(info["history"].numpy()).all()
    rmse = _rmse(tlm.compute_residuals(cam, poses, obs, mask, objp), mask.numpy())
    assert rmse < 0.43, rmse  # the 0.3 px * sqrt(2) noise floor is 0.424


def test_bench_x0_frames_are_the_baseline_problem():
    x0 = np.load(BENCH_X0)
    prob = np.load(os.path.join(ROOT, "BASELINE_PROBLEM.npz"))
    np.testing.assert_array_equal(x0["use_frames"], prob["use_frames"])
    for key in ("n_cameras", "n_frames", "seed"):
        assert int(x0[key]) == int(prob[key])
    assert x0["cam0"].shape == (6, 12)
    assert x0["poses0"].shape == (len(prob["use_frames"]), 6)
    assert np.isfinite(x0["cam0"]).all() and np.isfinite(x0["poses0"]).all()


@pytest.mark.parametrize("seed", [0, 11])
def test_synthetic_rig_is_bit_identical(seed):
    kw = dict(n_cameras=4, n_frames=60, noise_px=0.3, dropout=0.25,
              outlier_frac=0.1, seed=seed)
    a, b = tmct.make_synthetic_rig(**kw), jmct.make_synthetic_rig(**kw)
    for field in ("all_extrinsics", "calib_poses", "calib_objpoints", "all_calib_uvs"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    for (Ka, da), (Kb, db) in zip(a.all_intrinsics, b.all_intrinsics):
        np.testing.assert_array_equal(Ka, Kb)
        np.testing.assert_array_equal(da, db)
    assert a.img_sizes == b.img_sizes
    np.testing.assert_array_equal(
        tmct.generate_chessboard_objpoints((6, 9), 7.5),
        jmct.generate_chessboard_objpoints((6, 9), 7.5),
    )


def test_convert_carries_parameters_and_options():
    rng = np.random.default_rng(3)
    cam, poses = rng.normal(size=(6, 12)), rng.normal(size=(20, 6))
    for dtype in (torch.float64, torch.float32):
        t = convert.cam_params_from_jax(cam, dtype=dtype)
        assert t.dtype == dtype and t.shape == (6, 12)
        np.testing.assert_array_equal(t.numpy(), cam.astype(t.numpy().dtype))
    np.testing.assert_array_equal(convert.poses_from_jax(poses).numpy(), poses)
    with pytest.raises(ValueError):
        convert.poses_from_jax(cam)
    jopts = jlm.LMOptions(block_impl="pallas", cost_impl="auto", **BENCH_OPTS)
    topts = convert.lm_options_from_jax(dataclasses.asdict(jopts))
    assert topts.block_impl == "cuda" and topts.cost_impl == "auto"
    assert dataclasses.asdict(topts) | {"block_impl": "pallas"} == dataclasses.asdict(jopts)
    # JAX's default options keep JAX's routes: its cost_impl "xla" carries
    # over as "torch", where the port's own default is "auto"
    carried = convert.lm_options_from_jax(dataclasses.asdict(jlm.LMOptions()))
    assert jlm.LMOptions().cost_impl == "xla" and carried.cost_impl == "torch"
    assert tlm.LMOptions().cost_impl == "auto"
    assert carried == dataclasses.replace(tlm.LMOptions(), cost_impl="torch")


def test_bundle_adjustment_helpers_match_jax():
    rig = jmct.make_synthetic_rig(n_cameras=3, n_frames=10, seed=5)
    ext, intr, poses = rig.all_extrinsics, rig.all_intrinsics, rig.calib_poses
    cam = tba._params_to_arrays(ext, intr)
    np.testing.assert_array_equal(cam, jba._params_to_arrays(ext, intr))
    ext_t, intr_t = tba._arrays_to_params(torch.as_tensor(cam))
    ext_j, intr_j = jba._arrays_to_params(cam)
    np.testing.assert_array_equal(ext_t, ext_j)
    for (Kt, dt), (Kj, dj) in zip(intr_t, intr_j):
        np.testing.assert_array_equal(Kt, Kj)
        np.testing.assert_array_equal(dt, dj)
    x = tba.serialize_params(ext, intr, poses)
    np.testing.assert_array_equal(x, jba.serialize_params(ext, intr, poses))
    for a, b in zip(tba.deserialize_params(x, 3)[::2], jba.deserialize_params(x, 3)[::2]):
        np.testing.assert_array_equal(a, b)
    pred_t = tba.predict_calib_uvs(ext, intr, rig.calib_objpoints, poses, device="cpu").numpy()
    pred_j = np.asarray(jba.predict_calib_uvs(ext, intr, rig.calib_objpoints, poses))
    np.testing.assert_allclose(pred_t, pred_j, rtol=1e-12)
    np.testing.assert_allclose(
        tba.embed_calib_objpoints(rig.calib_objpoints, poses, device="cpu").numpy(),
        np.asarray(jba.embed_calib_objpoints(rig.calib_objpoints, poses)),
        rtol=1e-12, atol=1e-12,
    )


def test_bundle_adjustment_helpers_default_to_the_card(monkeypatch):
    """device=None means the CUDA device: without one, numpy input raises
    instead of landing on the CPU; tensor input keeps its own device."""
    rig = jmct.make_synthetic_rig(n_cameras=2, n_frames=3, seed=5)
    ext, intr, poses = rig.all_extrinsics, rig.all_intrinsics, rig.calib_poses
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tba.embed_calib_objpoints(rig.calib_objpoints, poses)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tba.predict_calib_uvs(ext, intr, rig.calib_objpoints, poses)
    pred = tba.predict_calib_uvs(ext, intr, rig.calib_objpoints, torch.as_tensor(poses))
    assert pred.device.type == "cpu" and pred.dtype == torch.float64
    assert pred.shape == (2, 3, rig.calib_objpoints.shape[0], 2)


def test_port_imports_without_jax():
    """Importing the port, and running the analysis entry points on the CPU,
    loads neither JAX nor the JAX package."""
    code = (
        "import sys, numpy as np, multicam_calibration_tpu_torch as m, "
        "multicam_calibration_tpu_torch.convert, "
        "multicam_calibration_tpu_torch.ops.ba_cuda\n"
        "rig = m.make_synthetic_rig(3, 8, seed=5)\n"
        "ext, intr = rig.all_extrinsics, rig.all_intrinsics\n"
        "m.triangulate(list(rig.all_calib_uvs[:, 0]), list(ext), intr, device='cpu')\n"
        "m.flatibrate(np.random.default_rng(0).normal(size=(50, 3)), device='cpu')\n"
        "m.calibration_uncertainty(rig.all_calib_uvs, ext, intr, rig.calib_objpoints, "
        "rig.calib_poses, device='cpu')\n"
        "m.RollingCalibrator(ext, intr, rig.calib_objpoints, window=8, "
        "device='cpu').update(rig.all_calib_uvs[:, :4])\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'multicam_calibration_tpu' not in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
