"""The port's lm_core vs the JAX package's, on ``__graft_entry__._tiny_problem``.

3 cameras x 16 frames x 35 points in f64, from a seeded perturbation of the
ground truth so every gradient and step is nontrivial. In pure f64 both
packages run the same formulas and agree to f64 rounding amplified by the
reductions and solves: rtol 1e-10. Under the mixed f32 recipe the two
packages round the f32 products in different orders, so the blocks agree to
f32 rounding: U/V/W atol 2e-5 * max|.| and gradients atol
3e-5 * max(1, max|.|) (the kernel-parity tolerances of
tests/test_ba_pallas.py). Each test states any other tolerance it uses.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from multicam_calibration_tpu.models import lm_core as jlm
from multicam_calibration_tpu_torch.models import lm_core as tlm

RTOL = 1e-10
RECIPE = dict(
    jac_dtype="float32", block_dtype="float32", grad_dtype="float32",
    cost_dtype="float32",
)


@pytest.fixture(scope="module")
def tiny():
    """The tiny problem as numpy arrays, from a perturbed start."""
    cam, poses, obs, mask, objp = (
        np.array(x) for x in __graft_entry__._tiny_problem(dtype=jnp.float64)
    )
    rng = np.random.default_rng(7)
    cam = cam + rng.normal(0, 1e-3, cam.shape) * np.r_[[100.0] * 4, [1.0] * 8]
    poses = poses + rng.normal(0, 1e-3, poses.shape)
    return cam, poses, obs, mask, objp


def _j(p):
    return tuple(jnp.asarray(x) for x in p)


def _t(p):
    return tuple(torch.as_tensor(x) for x in p)


def _close(port, ref, rtol=RTOL, atol_rel=1e-13):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(
        port, ref, rtol=rtol, atol=atol_rel * max(1.0, float(np.abs(ref).max()))
    )


def test_compute_residuals(tiny):
    _close(tlm.compute_residuals(*_t(tiny)), jlm.compute_residuals(*_j(tiny)))


@pytest.mark.parametrize("loss", ["soft_l1", "linear"])
def test_compute_cost_f64(tiny, loss):
    jo, to = jlm.LMOptions(loss=loss, f_scale=0.7), tlm.LMOptions(loss=loss, f_scale=0.7)
    _close(
        tlm.compute_cost(*_t(tiny), to), jlm.compute_cost(*_j(tiny), jo)
    )


def test_compute_cost_f32_projection(tiny):
    """cost_dtype="float32": both project in f32, in different operation
    orders. The f32 spacing at ~600 px coordinates is ~6e-5 px against
    residuals of ~1 px, so the totals agree to 1e-5 relative."""
    _close(
        tlm.compute_cost(*_t(tiny), tlm.LMOptions(cost_dtype="float32")),
        jlm.compute_cost(*_j(tiny), jlm.LMOptions(cost_dtype="float32")),
        rtol=1e-5,
    )


def test_project_board_points(tiny):
    cam, poses, _, _, objp = tiny
    _close(
        tlm.project_board_points(*_t((cam[1], poses[3], objp))),
        jlm.project_board_points(*_j((cam[1], poses[3], objp))),
    )


def _assert_blocks(port, ref, rtol=RTOL, f32=False):
    for name, a, b in zip(("U", "V", "W", "g_cam", "g_pose", "cost"), port, ref):
        b = np.asarray(b, np.float64)
        a = a.numpy()
        if f32 and name in ("U", "V", "W"):
            np.testing.assert_allclose(
                a, b, atol=2e-5 * float(np.abs(b).max()), err_msg=name
            )
        elif f32:
            np.testing.assert_allclose(
                a, b, atol=3e-5 * max(1.0, float(np.abs(b).max())), rtol=1e-6,
                err_msg=name,
            )
        else:
            _close(a, b, rtol=rtol)


def test_linearize_analytic_f64(tiny):
    _assert_blocks(
        tlm._linearize_analytic(*_t(tiny), tlm.LMOptions()),
        jlm._linearize_analytic(*_j(tiny), jlm.LMOptions()),
    )


def test_linearize_analytic_f32_recipe(tiny):
    _assert_blocks(
        tlm._linearize_analytic(*_t(tiny), tlm.LMOptions(**RECIPE)),
        jlm._linearize_analytic(*_j(tiny), jlm.LMOptions(**RECIPE)),
        f32=True,
    )


def test_build_normal_blocks_with_freezes(tiny):
    cam = tiny[0]
    cam_free = np.ones(cam.shape)
    cam_free[0, 6:] = 0.0  # gauge root extrinsics frozen
    pose_free = np.ones(tiny[1].shape)
    pose_free[2] = 0.0
    free = (cam_free, pose_free)
    port = tlm.build_normal_blocks(*_t(tiny), tlm.LMOptions(), *_t(free))
    ref = jlm.build_normal_blocks(*_j(tiny), jlm.LMOptions(), *_j(free))
    _assert_blocks(port, ref)


@pytest.mark.parametrize("lam", [1e-4, 1.0])
def test_schur_solve_f64(tiny, lam):
    blocks_t = tlm.build_normal_blocks(*_t(tiny), tlm.LMOptions())
    blocks_j = jlm.build_normal_blocks(*_j(tiny), jlm.LMOptions())
    dcam_t, dpose_t = tlm.schur_solve(blocks_t, lam)
    dcam_j, dpose_j = jlm.schur_solve(blocks_j, jnp.asarray(lam))
    # The damped camera system's conditioning amplifies the blocks' f64
    # rounding differences; 1e-10 of the largest step component bounds it.
    _close(dcam_t, dcam_j, atol_rel=1e-10)
    _close(dpose_t, dpose_j, atol_rel=1e-10)


def test_schur_solve_f32(tiny):
    """solve_dtype="float32": both solve the same f64 blocks in f32; the
    steps agree to f32 rounding amplified by the damped system's
    conditioning (1e-3 of the largest component)."""
    blocks_t = tlm.build_normal_blocks(*_t(tiny), tlm.LMOptions())
    blocks_j = jlm.build_normal_blocks(*_j(tiny), jlm.LMOptions())
    dcam_t, dpose_t = tlm.schur_solve(blocks_t, 1e-2, opts=tlm.LMOptions(solve_dtype="float32"))
    dcam_j, dpose_j = jlm.schur_solve(
        blocks_j, jnp.asarray(1e-2), opts=jlm.LMOptions(solve_dtype="float32")
    )
    for a, b in ((dcam_t, dcam_j), (dpose_t, dpose_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-3 * float(np.abs(b).max()))


def test_not_ported_options_raise(tiny, tmp_path):
    """Every option is ported: frame sharding (``axis_name``) over a group
    of one process equals no sharding, bit for bit (tests/test_torch_parallel.py
    runs two ranks); the chunked layout and the jacfwd oracle are ported
    (tests/test_torch_lm_chunked.py) and an unknown Jacobian mode raises."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        opts = tlm.LMOptions(max_iters=3, damping_schedule="nielsen")
        assert torch.equal(tlm.compute_cost(*_t(tiny), opts, axis_name=group),
                           tlm.compute_cost(*_t(tiny), opts))
        blocks = tlm.build_normal_blocks(*_t(tiny), opts, axis_name=group)
        for a, b in zip(blocks, tlm.build_normal_blocks(*_t(tiny), opts)):
            assert torch.equal(a, b)
        for a, b in zip(tlm.schur_solve(blocks, 1e-2, axis_name=group, opts=opts),
                        tlm.schur_solve(blocks, 1e-2, opts=opts)):
            assert torch.equal(a, b)
        cam_g, poses_g, info_g = tlm.lm_solve(*_t(tiny), opts, axis_name=group)
        cam, poses, info = tlm.lm_solve(*_t(tiny), opts)
        assert torch.equal(cam_g, cam) and torch.equal(poses_g, poses)
        assert torch.equal(info_g.pop("history"), info.pop("history")) and info_g == info
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="jacobian"):
        tlm.build_normal_blocks(*_t(tiny), tlm.LMOptions(jacobian="jvp"))
    assert tlm.build_normal_blocks(*_t(tiny), tlm.LMOptions(frame_chunk=4)).W.ndim == 5
    assert tlm.build_normal_blocks(*_t(tiny), tlm.LMOptions(jacobian="jacfwd")).W.ndim == 4
    # frame_chunk >= F is the dense layout, as in the JAX package.
    assert tlm.build_normal_blocks(*_t(tiny), tlm.LMOptions(frame_chunk=16)).W.ndim == 4


def test_options_match_jax_fields():
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(jlm.LMOptions)}
    tf = {f.name: f.default for f in dataclasses.fields(tlm.LMOptions)}
    assert jf.keys() == tf.keys()
    assert jf["block_impl"] == tf["block_impl"] == "auto"
    # The per-try cost: JAX defaults to its XLA route; the port to "auto",
    # its kernel on CUDA tensors with the f32-cost recipe and torch otherwise.
    assert (jf["cost_impl"], tf["cost_impl"]) == ("xla", "auto")
    for k, v in jf.items():
        if not k.endswith("_impl"):
            assert tf[k] == v, k
    assert tlm.HIST_FIELDS == jlm.HIST_FIELDS


def test_entry_points_pin_tf32_off():
    """The GPU analogue of with_highest_precision: TF32 is off inside the
    solver's entry points and the caller's settings come back after."""
    from multicam_calibration_tpu_torch.device import with_highest_precision

    seen = {}

    @with_highest_precision
    def probe():
        seen["matmul"] = torch.backends.cuda.matmul.allow_tf32
        seen["cudnn"] = torch.backends.cudnn.allow_tf32
        seen["precision"] = torch.get_float32_matmul_precision()

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        probe()
        assert seen == {"matmul": False, "cudnn": False, "precision": "highest"}
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
    for fn in (tlm.lm_solve, tlm.build_normal_blocks, tlm.schur_solve, tlm.compute_cost):
        assert fn.__wrapped__ is not None  # decorated entry points
