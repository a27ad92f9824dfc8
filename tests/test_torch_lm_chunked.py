"""The chunked slab layout and the jacfwd oracle of the port's lm_core.

Mirrors tests/test_lm_chunked.py (:52-135) on the port, and holds it against
the JAX package's chunked build and solve on the same numpy problem (a
4-camera rig, 50 frames, seeded start near the truth), in f64 on the CPU:

- chunked blocks (frame_chunk 16, and 7, which does not divide F: padded
  frames with zero poses and empty masks) equal the dense ones at rtol
  1e-10 (one f64 sum in two orders) and JAX's chunked blocks, in the same
  (nc, ck, ...) layout, at rtol 1e-10; the chunked Schur step equals the
  dense one at rtol 1e-7 atol 1e-9 (as JAX's test) and its padded rows are
  exactly 0;
- the chunked solve reaches the dense optimum (rtol 1e-6, iterations
  within 3, as JAX's test) and JAX's chunked solve (f64: the same
  iterations, cost rtol 1e-9); ``cam_free`` / ``pose_free`` hold frozen
  entries exactly under chunks;
- the chunked kernel route (the kernels' plain twins on the CPU) equals the
  dense kernel route at the f32 recipe's rtol 2e-6 (f32 partial sums per
  slab);
- ``jacobian="jacfwd"`` (torch.func.jacfwd) equals the analytic blocks at
  f64 roundoff (1e-12 of each block's magnitude) and JAX's jacfwd build
  (rtol 1e-10).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multicam_calibration_tpu as jmct
from multicam_calibration_tpu.models import lm_core as jlm
from multicam_calibration_tpu_torch.models import lm_core as tlm
from multicam_calibration_tpu_torch.models.bundle_adjustment import _params_to_arrays


@pytest.fixture(scope="module")
def problem():
    rig = jmct.make_synthetic_rig(n_cameras=4, n_frames=50, noise_px=0.4, dropout=0.2, seed=5)
    full = ~np.isnan(rig.all_calib_uvs).any((-1, -2))
    use = np.nonzero(full.sum(0) > 1)[0]
    obs_np = rig.all_calib_uvs[:, use]
    rng = np.random.default_rng(3)
    cam = _params_to_arrays(rig.all_extrinsics, rig.all_intrinsics)
    cam = cam + rng.normal(0, 1e-3, cam.shape) * np.r_[[50.0] * 4, [1.0] * 8]
    poses = rig.calib_poses[use] + rng.normal(0, 1e-3, (len(use), 6))
    return (cam, poses, np.nan_to_num(obs_np), ~np.isnan(obs_np).any(-1),
            rig.calib_objpoints)


# One compiled program per option set (eager JAX dispatches the vmapped
# jacfwd build op by op, ~10x slower).
_jax_build = jax.jit(jlm.build_normal_blocks, static_argnames=("opts",))


def _t(p):
    return tuple(torch.as_tensor(x) for x in p)


def _j(p):
    return tuple(jnp.asarray(x) for x in p)


def _dense_layout(b, C, F):
    """Chunked (V, W, g_pose) -> the dense (F, ...) layout."""
    V = np.asarray(b.V).reshape(-1, 6, 6)[:F]
    W = np.moveaxis(np.asarray(b.W), 1, 0).reshape(C, -1, 12, 6)[:, :F]
    gp = np.asarray(b.g_pose).reshape(-1, 6)[:F]
    return V, W, gp


@pytest.mark.parametrize("chunk", [16, 7])  # 7 does not divide F -> padding
def test_chunked_blocks_match_dense_and_jax(problem, chunk):
    C, F = problem[0].shape[0], problem[1].shape[0]
    assert F > chunk and F % 7
    bd = tlm.build_normal_blocks(*_t(problem), tlm.LMOptions())
    bc = tlm.build_normal_blocks(*_t(problem), tlm.LMOptions(frame_chunk=chunk))
    bj = _jax_build(*_j(problem), opts=jlm.LMOptions(frame_chunk=chunk))
    nc = -(-F // chunk)
    assert bc.V.shape == (nc, chunk, 6, 6) and bc.W.shape == (nc, C, chunk, 12, 6)
    for got, ref in ((bc.U, bd.U), (bc.g_cam, bd.g_cam), (bc.cost, bd.cost)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-10, atol=1e-8)
    for got, ref in zip(_dense_layout(bc, C, F), (bd.V, bd.W, bd.g_pose)):
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-10, atol=1e-8)
    for got, ref in zip(bc, bj):  # the same chunked layout as JAX's
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-8)

    dcam_d, dpose_d = tlm.schur_solve(bd, 1e-4)
    dcam_c, dpose_c = tlm.schur_solve(bc, 1e-4)
    np.testing.assert_allclose(dcam_c.numpy(), dcam_d.numpy(), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(dpose_c[:F].numpy(), dpose_d.numpy(), rtol=1e-7, atol=1e-9)
    assert dpose_c.shape == (nc * chunk, 6) and bool((dpose_c[F:] == 0).all())


@pytest.mark.parametrize("jac_dtype", [None, "float32"])
def test_chunked_lm_matches_dense(problem, jac_dtype):
    _, _, i_d = tlm.lm_solve(*_t(problem), tlm.LMOptions(jac_dtype=jac_dtype))
    _, _, i_c = tlm.lm_solve(*_t(problem), tlm.LMOptions(jac_dtype=jac_dtype, frame_chunk=16))
    assert abs(i_c["n_iters"] - i_d["n_iters"]) <= 3
    np.testing.assert_allclose(i_c["final_cost"], i_d["final_cost"], rtol=1e-6)


def test_chunked_lm_matches_jax(problem):
    """f64, a frame count the chunk does not divide: the same trajectory as
    JAX's chunked solve."""
    _, poses_t, i_t = tlm.lm_solve(*_t(problem), tlm.LMOptions(frame_chunk=7))
    _, poses_j, i_j = jlm.lm_solve(*_j(problem), jlm.LMOptions(frame_chunk=7))
    assert i_t["n_iters"] == int(i_j["n_iters"]) and i_t["nfev"] == int(i_j["nfev"])
    np.testing.assert_allclose(i_t["final_cost"], float(i_j["final_cost"]), rtol=1e-9)
    assert poses_t.shape == poses_j.shape


def test_chunked_respects_free_masks(problem):
    cam0, poses0 = problem[0], problem[1]
    C, F = cam0.shape[0], poses0.shape[0]
    cam_free = torch.ones((C, 12), dtype=torch.float64)
    cam_free[:, :6] = 0.0  # freeze intrinsics
    pose_free = torch.ones((F, 6), dtype=torch.float64)
    pose_free[::3] = 0.0  # freeze every 3rd pose
    kw = dict(cam_free=cam_free, pose_free=pose_free)
    _, _, i_d = tlm.lm_solve(*_t(problem), tlm.LMOptions(), **kw)
    cam_c, poses_c, i_c = tlm.lm_solve(*_t(problem), tlm.LMOptions(frame_chunk=7), **kw)
    np.testing.assert_array_equal(cam_c[:, :6].numpy(), cam0[:, :6])
    np.testing.assert_array_equal(poses_c[::3].numpy(), poses0[::3])
    assert not np.array_equal(poses_c[1::3].numpy(), poses0[1::3])
    np.testing.assert_allclose(i_c["final_cost"], i_d["final_cost"], rtol=1e-6)


def test_chunked_kernel_route_matches_dense(problem, monkeypatch):
    """The kernel route's chunked slabs (``_prepare``) through the kernels'
    plain twins, put in the wrappers' place (the wrappers refuse CPU
    tensors)."""
    monkeypatch.setattr(tlm, "_route", lambda impl, name, ok, req, objp: ok)
    monkeypatch.setattr(tlm.ba_cuda, "ba_chunk_blocks", tlm.ba_chunk_blocks_reference)
    monkeypatch.setattr(tlm.ba_cuda, "ba_chunk_cost", tlm.ba_chunk_cost_reference)
    recipe = tlm.LMOptions(jac_dtype="float32", block_dtype="float32",
                           grad_dtype="float32", cost_dtype="float32")
    assert tlm._cuda_block_build(recipe, torch.float64, _t(problem)[4])
    C, F = problem[0].shape[0], problem[1].shape[0]
    pose_free = torch.ones((F, 6), dtype=torch.float64)
    pose_free[::4] = 0.0
    bd = tlm.build_normal_blocks(*_t(problem), recipe, pose_free=pose_free)
    bc = tlm.build_normal_blocks(*_t(problem), dataclasses.replace(recipe, frame_chunk=7),
                                 pose_free=pose_free)
    for got, ref in ((bc.U, bd.U), (bc.g_cam, bd.g_cam), (bc.cost, bd.cost)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-6,
                                   atol=2e-6 * float(ref.abs().max()))
    for got, ref in zip(_dense_layout(bc, C, F), (bd.V, bd.W, bd.g_pose)):
        np.testing.assert_allclose(got, ref.numpy(), rtol=2e-6,
                                   atol=2e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("chunk", [None, 16])
def test_jacfwd_matches_analytic_and_jax(problem, chunk):
    opts = tlm.LMOptions(frame_chunk=chunk)
    ba = tlm.build_normal_blocks(*_t(problem), opts)
    bf = tlm.build_normal_blocks(*_t(problem), dataclasses.replace(opts, jacobian="jacfwd"))
    for got, ref in zip(bf, ba):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-12 * float(ref.abs().max()))
    if chunk is None:
        bj = _jax_build(*_j(problem), opts=jlm.LMOptions(jacobian="jacfwd"))
        for got, ref in zip(bf, bj):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                                       atol=1e-12 * float(np.abs(ref).max()))


def test_jacfwd_recipe_matches_jax(problem):
    """The oracle under the mixed recipe: Jacobians and products in f32,
    per-(c, f) blocks cast to f64 before the frame sums, as JAX's per_cf."""
    kw = dict(jac_dtype="float32", block_dtype="float32", grad_dtype="float32",
              jacobian="jacfwd")
    bt = tlm.build_normal_blocks(*_t(problem), tlm.LMOptions(**kw))
    bj = _jax_build(*_j(problem), opts=jlm.LMOptions(**kw))
    for got, ref in zip(bt, bj):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=2e-6 * np.abs(ref).max())
