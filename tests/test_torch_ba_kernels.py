"""The port's bundle-adjustment kernels vs the JAX Pallas kernels.

The wrappers ``ops.ba_cuda.ba_chunk_blocks`` / ``ba_chunk_cost`` run only
on a card and refuse CPU tensors; on the CPU ``models.lm_core`` chooses
their plain PyTorch twins (``lm_core.ba_chunk_blocks_reference`` /
``ba_chunk_cost_reference``). Those twins are held against the JAX Pallas kernels run in interpret mode, on the problem
of tests/test_ba_pallas.py (C=3, F=8, N=35, seed 4, tile_f=8), at that
file's tolerances: the Pallas kernel runs a two-float f32 chain and f32
contractions, the twin an f64 chain and f32 contractions in another order,
so fragments agree to f32 rounding:
U/V/W atol 2e-5 * max|.|, gradients atol 3e-5 * max(1, max|.|), total
cost rtol 3e-5, per-(c, f) cost fragments rtol 2e-5 atol 1e-7. The cost
wrapper's f64 total is the f64 sum of its own fragments (rtol 1e-12).

The cost parity here is against the JAX package's Pallas route (an f64-grade
residual, which the CUDA kernel and its twin also compute), not against its
XLA route (an f32 projection, which the port's ``cost_impl="torch"`` path
mirrors; tests/test_torch_lm_core.py and tests/test_torch_slice.py compare
that one).
"""
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import multicam_calibration_tpu as jmct
from multicam_calibration_tpu.models.bundle_adjustment import _params_to_arrays
from multicam_calibration_tpu.ops import ba_pallas
from multicam_calibration_tpu_torch.models import lm_core as tlm
from multicam_calibration_tpu_torch.ops import ba_cuda
from multicam_calibration_tpu_torch.ops.rotation import so3_exp, so3_left_jacobian
from multicam_calibration_tpu_torch.utils.metrics import metrics
from tests.test_torch_cuda import EDGE_ANGLES, _problem

C, F, N = 3, 8, 35
RECIPE = dict(
    jac_dtype="float32", block_dtype="float32", grad_dtype="float32",
    cost_dtype="float32",
)


def _rig_problem(n_cameras, n_frames, seed, perturb_seed=None, shift=0.0):
    rig = jmct.make_synthetic_rig(
        n_cameras=n_cameras, n_frames=n_frames, noise_px=0.3, dropout=0.3,
        seed=seed,
    )
    ext = rig.all_extrinsics
    if perturb_seed is not None:
        rng = np.random.default_rng(perturb_seed)
        ext = ext + rng.normal(0, 1e-3, ext.shape)
    cam = _params_to_arrays(ext, rig.all_intrinsics) + shift
    poses = np.nan_to_num(rig.calib_poses)
    mask = ~np.isnan(rig.all_calib_uvs).any(-1)
    obs = np.nan_to_num(rig.all_calib_uvs)
    return cam, poses, obs, mask, rig.calib_objpoints


def _jax_blocks(p, tile_f, loss_linear=False):
    cam, poses, obs, mask, objp = (jnp.asarray(x) for x in p)
    obs_hi, obs_lo, msk = ba_pallas.ba_prepare_obs(obs, mask)
    out = ba_pallas.ba_chunk_blocks(
        cam, poses, obs_hi, obs_lo, msk, objp, tile_f=tile_f,
        loss_linear=loss_linear, interpret=True,
    )
    return [np.asarray(x, np.float64) for x in out]


def _port(fn, p, **kw):
    cam, poses, obs, mask, objp = (torch.as_tensor(x) for x in p)
    out = fn(cam, poses, *ba_cuda.ba_prepare_obs(obs, mask), objp, **kw)
    if isinstance(out, torch.Tensor):
        return out.double().numpy()
    return [x.double().numpy() for x in out]


def _launches():
    """The BA kernels' launch counters (``utils.metrics``)."""
    return tuple(metrics.stage_times.get(f"{k}.launches", 0)
                 for k in ("ba_blocks_kernel", "ba_cost_kernel"))


def _refused(fn, p):
    """``fn`` refuses the CPU tensors of ``p`` before it launches anything."""
    before = _launches()
    with pytest.raises(ValueError, match="CUDA"):
        _port(fn, p)
    assert _launches() == before


@pytest.fixture(scope="module")
def problem():
    return _rig_problem(C, F, seed=4, perturb_seed=2)


def _assert_blocks_close(port, ref):
    for name, a, b in zip(("U", "V", "W"), port[:3], ref[:3]):
        np.testing.assert_allclose(
            a, b, atol=2e-5 * float(np.abs(b).max()), err_msg=name
        )
    for name, a, b in zip(("g_cam", "g_pose"), port[3:5], ref[3:5]):
        atol = 3e-5 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)
        # and after the f64 frame (g_cam) / camera (g_pose) reductions
        axis = 1 if name == "g_cam" else 0
        red = b.sum(axis)
        np.testing.assert_allclose(
            a.sum(axis), red, atol=3e-5 * max(1.0, float(np.abs(red).max())),
            err_msg=name,
        )
    np.testing.assert_allclose(port[5].sum(), ref[5].sum(), rtol=3e-5)


@pytest.mark.parametrize("loss_linear", [False, True], ids=["soft_l1", "linear"])
def test_block_twin_matches_pallas_kernel(problem, loss_linear):
    port = _port(tlm.ba_chunk_blocks_reference, problem, loss_linear=loss_linear)
    ref = _jax_blocks(problem, tile_f=8, loss_linear=loss_linear)
    assert [x.shape for x in port] == [x.shape for x in ref]
    _assert_blocks_close(port, ref)
    # The wrapper takes no CPU tensor: the twin is the caller's choice.
    _refused(ba_cuda.ba_chunk_blocks, problem)


def test_block_wrapper_is_twin_on_cpu(problem):
    """lm_core's choice on CPU tensors under the kernels' recipe is the
    twin's math: its blocks are the twin's fragments reduced, bit for bit,
    and the wrapper refuses the same tensors."""
    cam, poses, obs, mask, objp = (torch.as_tensor(x) for x in problem)
    got = tlm.build_normal_blocks(cam, poses, obs, mask, objp, tlm.LMOptions(**RECIPE))
    U, V, W, g_cam, g_pose, cost = (x.double() for x in tlm.ba_chunk_blocks_reference(
        cam, poses, *ba_cuda.ba_prepare_obs(obs, mask), objp))
    for x, y in zip(got, (U, V, W, g_cam.sum(1), g_pose.sum(0), cost.sum())):
        assert torch.equal(x, y)
    _refused(ba_cuda.ba_chunk_blocks, problem)


@pytest.mark.parametrize("loss_linear", [False, True], ids=["soft_l1", "linear"])
def test_cost_twin_matches_pallas_kernel(problem, loss_linear):
    cam, poses, obs, mask, objp = (jnp.asarray(x) for x in problem)
    obs_hi, obs_lo, msk = ba_pallas.ba_prepare_obs(obs, mask)
    ref = np.asarray(
        ba_pallas.ba_chunk_cost(
            cam, poses, obs_hi, obs_lo, msk, objp, tile_f=8,
            loss_linear=loss_linear, interpret=True,
        ),
        np.float64,
    )
    port, total = _port(tlm.ba_chunk_cost_reference, problem, loss_linear=loss_linear)
    assert port.shape == ref.shape == (C, F)
    np.testing.assert_allclose(port, ref, rtol=2e-5, atol=1e-7)
    # the total: the f64 sum of the wrapper's fragments, and Pallas's at the
    # total-cost tolerance
    assert total.shape == ()
    np.testing.assert_allclose(total, port.sum(), rtol=1e-12)
    np.testing.assert_allclose(total, ref.sum(), rtol=3e-5)
    _refused(ba_cuda.ba_chunk_cost, problem)


def test_padded_frames_near_identity_camera():
    """Zero-pose padded frames + a camera with tiny nonzero extrinsics
    (test_ba_pallas.py:248-310): every fragment stays finite, padding adds
    nothing, and the blocks match the Pallas kernel run with tile_f=64
    (70 frames -> 58 zero-pose padded frames inside the Pallas wrapper)."""
    cam, poses, obs, mask, objp = _rig_problem(2, 70, seed=9, shift=3e-5)
    pad = 128 - 70  # the port's twin does not pad: pad by hand
    padded = (
        cam,
        np.concatenate([poses, np.zeros((pad, 6))]),
        np.concatenate([obs, np.zeros((2, pad, N, 2))], 1),
        np.concatenate([mask, np.zeros((2, pad, N), bool)], 1),
        objp,
    )
    port_pad = _port(tlm.ba_chunk_blocks_reference, padded)
    for name, x in zip(("U", "V", "W", "g_cam", "g_pose", "cost"), port_pad):
        assert np.isfinite(x).all(), name
    assert np.abs(port_pad[1][70:]).max() == 0.0
    assert np.abs(port_pad[2][:, 70:]).max() == 0.0
    assert np.abs(port_pad[5][:, 70:]).max() == 0.0
    port = _port(tlm.ba_chunk_blocks_reference, (cam, poses, obs, mask, objp))
    ref = _jax_blocks((cam, poses, obs, mask, objp), tile_f=64)
    _assert_blocks_close(port, ref)


class _AsIfOnCard:
    """Stands for a tensor on a CUDA device, for the dispatch's device check."""

    def __init__(self, tensor):
        self.shape = tensor.shape
        self.device = torch.device("cuda", 0)


def test_dispatch_policy(problem):
    """The default ('auto') on CPU tensors takes the plain path and on CUDA
    tensors the kernels, exactly when the recipe holds; 'torch' never;
    'cuda' on CPU tensors raises; recipes the kernels do not implement
    never route to them."""
    objp = torch.as_tensor(problem[4])
    f64 = torch.float64
    recipe = tlm.LMOptions(**RECIPE)
    assert recipe.block_impl == recipe.cost_impl == "auto"
    assert not tlm._cuda_block_build(recipe, f64, objp)
    assert not tlm._cuda_cost_eval(recipe, f64, objp)
    assert not tlm._cuda_cost_eval(
        tlm.LMOptions(cost_impl="auto", **RECIPE), f64, objp
    )
    assert not tlm._cuda_block_build(tlm.LMOptions(), f64, objp)
    assert not tlm._cuda_block_build(tlm.LMOptions(block_impl="torch", **RECIPE), f64, objp)
    # the same options on CUDA tensors: the default routes to both kernels
    on_card = _AsIfOnCard(objp)
    assert tlm._cuda_block_build(recipe, f64, on_card)
    assert tlm._cuda_cost_eval(recipe, f64, on_card)
    assert tlm._cuda_cost_eval(tlm.LMOptions(cost_dtype="float32"), f64, on_card)
    assert not tlm._cuda_cost_eval(tlm.LMOptions(), f64, on_card)  # no f32 cost recipe
    assert not tlm._cuda_cost_eval(
        tlm.LMOptions(loss="huber", **RECIPE), f64, on_card
    )
    assert not tlm._cuda_cost_eval(
        tlm.LMOptions(cost_impl="torch", **RECIPE), f64, on_card
    )
    assert not tlm._cuda_block_build(
        tlm.LMOptions(block_impl="torch", **RECIPE), f64, on_card
    )
    assert tlm._cuda_cost_eval(tlm.LMOptions(cost_impl="cuda", **RECIPE), f64, on_card)
    assert not tlm._cuda_cost_eval(recipe, f64, _AsIfOnCard(torch.zeros((65, 3))))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlm._cuda_block_build(tlm.LMOptions(block_impl="cuda", **RECIPE), f64, objp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlm._cuda_cost_eval(tlm.LMOptions(cost_impl="cuda", **RECIPE), f64, objp)
    with pytest.raises(ValueError, match="all-f32"):
        tlm._cuda_block_build(tlm.LMOptions(block_impl="cuda"), f64, objp)
    with pytest.raises(ValueError, match="cost_dtype"):
        tlm._cuda_cost_eval(
            tlm.LMOptions(cost_impl="cuda", jac_dtype="float32"), f64, objp
        )
    with pytest.raises(ValueError):
        tlm._cuda_block_build(tlm.LMOptions(block_impl="pallas"), f64, objp)
    too_many = torch.zeros((65, 3), dtype=f64)
    assert not tlm._cuda_block_build(recipe, f64, too_many)
    with pytest.raises(ValueError, match="exceeds"):
        ba_cuda.ba_prepare_obs(
            torch.zeros((1, 1, 65, 2)), torch.ones((1, 1, 65), dtype=torch.bool)
        )


def test_auto_solve_on_cpu_never_launches(problem):
    cam, poses, obs, mask, objp = (torch.as_tensor(x) for x in problem)
    before = _launches()
    opts = tlm.LMOptions(max_iters=2, **RECIPE)
    assert opts.cost_impl == "auto" and opts.block_impl == "auto"
    _, _, info = tlm.lm_solve(cam, poses, obs, mask, objp, opts)
    assert np.isfinite(info["final_cost"])
    assert _launches() == before
    # on the CPU the default is the torch route: the same trajectory, bit for bit
    _, _, info_t = tlm.lm_solve(
        cam, poses, obs, mask, objp,
        tlm.LMOptions(max_iters=2, block_impl="torch", cost_impl="torch", **RECIPE),
    )
    assert info_t["final_cost"] == info["final_cost"]
    assert info_t["nfev"] == info["nfev"]
    assert torch.equal(info_t["history"], info["history"])


def test_prepare_obs_zeroes_unobserved_and_nan():
    obs = torch.tensor([[[[1.0, float("nan")], [3.0, 4.0]]]])  # (1, 1, 2, 2)
    mask = torch.tensor([[[True, False]]])
    out, msk = ba_cuda.ba_prepare_obs(obs, mask)
    assert out.dtype == torch.float64 and msk.dtype == torch.uint8
    assert out.is_contiguous() and msk.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), [[[[1.0, 0.0], [0.0, 0.0]]]])
    np.testing.assert_array_equal(msk.numpy(), [[[1, 0]]])


# ---------------------------------------------------------------------------
# The CUDA block build's tiling and reduction order, emulated in plain torch
# ---------------------------------------------------------------------------

KERNEL_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "multicam_calibration_tpu_torch", "csrc", "ba_kernels.cu",
)
THREADS = 256  # kThreads of the block kernel in csrc/ba_kernels.cu


def _frames_per_block(N):
    """frames_per_block of csrc/ba_kernels.cu: a thread per board point of
    the tile, a warp per frame."""
    return min(THREADS // N, THREADS // 32)

def _skew_poly(r, p, q, one):
    """I + p K + q K @ K, K = skew(r), as nested lists of scalars of r's type."""
    zero = one - one
    K = [[zero, -r[2], r[1]], [r[2], zero, -r[0]], [-r[1], r[0], zero]]
    return [
        [(one if i == j else zero) + p * K[i][j]
         + q * (K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j])
         for j in range(3)]
        for i in range(3)
    ]


def _so3_coefficients(r):
    """a = sin t / t, b = (1 - cos t) / t^2, c = (t - sin t) / t^3 of one
    rotation vector in f64, with the series below theta^2 = 1e-8."""
    r = [float(v) for v in r]
    t2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    if t2 < 1e-8:
        return r, 1.0 - t2 / 6.0, 0.5 - t2 / 24.0, 1.0 / 6.0 - t2 / 120.0
    t = math.sqrt(t2)
    return r, math.sin(t) / t, (1.0 - math.cos(t)) / t2, (t - math.sin(t)) / (t2 * t)


def _so3_exp_scalar(r):
    """The kernel's R = so3_exp(r), f64 scalars."""
    r, a, b, _ = _so3_coefficients(r)
    return _skew_poly(r, a, b, 1.0)


def _left_jacobian_scalar(r):
    """The kernel's J_l(r): evaluated in f64, rounded to f32."""
    r, _, b, c = _so3_coefficients(r)
    return np.float32(_skew_poly(r, b, c, 1.0)).tolist()


def _warp_sum(v):
    """The kernel's xor-shuffle tree over the last axis (32 lanes)."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def _emulated_blocks(cam, pose, obs, msk, objp, f_scale=1.0, loss_linear=False):
    """ba_blocks_kernel + ba_reduce_kernel in plain torch, in their order.

    Packs from the raw parameters with the scalar formulas; per (c, f) the
    weighted rows (f64 chain, f32 Jacobian), the 20-column Gram as two row
    halves [0, N) and [N, 2N) summed row by row and then added; cost per
    lane then the shuffle tree; U over the tile's frames in order, then over
    tiles lane-strided and the shuffle tree; V over cameras in order.
    (The kernel fuses each product and add into one FMA; this rounds twice.)
    """
    C, F, N = msk.shape
    f64, f32 = torch.float64, torch.float32
    Rc = torch.tensor([_so3_exp_scalar(c[6:9]) for c in cam.tolist()], dtype=f64)
    Jc = torch.tensor([_left_jacobian_scalar(c[6:9]) for c in cam.tolist()], dtype=f32)
    Rp = torch.tensor([_so3_exp_scalar(p[:3]) for p in pose.tolist()], dtype=f64)
    Jp = torch.tensor([_left_jacobian_scalar(p[:3]) for p in pose.tolist()], dtype=f32)
    live = msk.bool()
    # f64 chain (chain_residual)
    rb = torch.einsum("fij,nj->fni", Rp, objp)
    q = torch.einsum("cij,fnj->cfni", Rc, rb + pose[:, None, 3:]) + cam[:, None, None, 9:]
    z = torch.where(~live | (q[..., 2].abs() < 1e-12), 1.0, q[..., 2])
    x, y = q[..., 0] / z, q[..., 1] / z
    r2 = x * x + y * y
    k = lambda i: cam[:, i, None, None]  # noqa: E731
    s = 1.0 + r2 * (k(4) + r2 * k(5))
    res = torch.stack([obs[..., 0] - (k(0) * (x * s) + k(2)),
                       obs[..., 1] - (k(1) * (y * s) + k(3))], -1)
    res = torch.where(live[..., None], res, 0.0)
    # f32 rows (point_rows)
    fx, fy, k1, k2 = (cam[:, i, None, None].to(f32) for i in (0, 1, 4, 5))
    x, y, r2, s, z = (v.to(f32) for v in (x, y, r2, s, z))
    iz = 1.0 / z
    sp = k1 + 2.0 * k2 * r2
    d11, d12, d22 = s + 2.0 * x * x * sp, 2.0 * x * y * sp, s + 2.0 * y * y * sp
    M = torch.stack([
        torch.stack([d11, d12, -(d11 * x + d12 * y)], -1) * (fx * iz)[..., None],
        torch.stack([d12, d22, -(d12 * x + d22 * y)], -1) * (fy * iz)[..., None],
    ], -2)  # (C, F, N, 2, 3)
    wc = (q.to(f32) - cam[:, None, None, 9:].to(f32))[..., None, :]
    cr = torch.linalg.cross(wc.expand_as(M), M)
    mc = torch.einsum("cfnkj,cji->cfnki", M, Rc.to(f32))
    crb = torch.linalg.cross(rb.to(f32)[None, :, :, None].expand_as(mc), mc)
    xd, yd = (x * s)[..., None], (y * s)[..., None]
    zero, one = torch.zeros_like(xd), torch.ones_like(xd)
    fxy = torch.stack([fx * x, fy * y], -1) * r2[..., None]
    intr = torch.stack([torch.cat([xd, zero], -1), torch.cat([zero, yd], -1),
                        torch.cat([one, zero], -1), torch.cat([zero, one], -1),
                        fxy, fxy * r2[..., None]], -1)
    cols = torch.cat([intr, torch.einsum("cfnkj,cji->cfnki", cr, Jc), M,
                      torch.einsum("cfnkj,fji->cfnki", crb, Jp), mc], -1)
    r = res.to(f32)
    if loss_linear:
        w, rho = torch.ones_like(r), 0.5 * (r * r)
    else:
        fs2 = torch.tensor(f_scale * f_scale, dtype=f32)
        sq = torch.sqrt(1.0 + (r * r) / fs2)
        w, rho = torch.rsqrt(sq), fs2 * (sq - 1.0)
    rows = torch.cat([cols * w[..., None], (r * w)[..., None], torch.zeros_like(r)[..., None]], -1)
    rows = torch.where(live[..., None, None], rows, 0.0).reshape(C, F, 2 * N, 20)
    rho = torch.where(live[..., None], rho, 0.0)
    # Gram: two row halves, each summed row by row
    halves = []
    for h in range(2):
        acc = torch.zeros((C, F, 20, 20), dtype=f32)
        for i in range(h * N, (h + 1) * N):
            acc = acc + rows[:, :, i, :, None] * rows[:, :, i, None, :]
        halves.append(acc)
    G = halves[0] + halves[1]
    # cost: lane l holds points l and l + 32
    pc = torch.zeros((C, F, 64), dtype=f32)
    pc[..., :N] = (0.0 + rho[..., 0]) + rho[..., 1]
    cost = _warp_sum((0.0 + pc[..., :32]) + pc[..., 32:])
    # U: in-tile sum in warp order, then over tiles
    P = _frames_per_block(N)
    tiles = -(-F // P)
    Uf = torch.zeros((C, tiles * P, 12, 12), dtype=f32)
    Uf[:, :F] = G[:, :, :12, :12]
    Uf = Uf.reshape(C, tiles, P, 12, 12)
    u_tile = torch.zeros((C, tiles, 12, 12), dtype=f32)
    for wi in range(P):
        u_tile = u_tile + Uf[:, :, wi]
    lanes = torch.zeros((C, 12, 12, 32), dtype=f32)
    for t in range(tiles):
        lanes[..., t % 32] = lanes[..., t % 32] + u_tile[:, t]
    U = _warp_sum(lanes)
    V = torch.zeros((F, 6, 6), dtype=f32)
    for c in range(C):
        V = V + G[c, :, 12:18, 12:18]
    return (U, V, G[:, :, :12, 12:18], G[:, :, :12, 18], G[:, :, 12:18, 18], cost)


def test_emulation_tiling_matches_kernel_source():
    with open(KERNEL_SRC) as f:
        src = f.read()
    assert f"constexpr int kThreads = {THREADS};" in src
    assert "constexpr int kWarps = kThreads / 32;" in src
    assert "return kThreads / N < kWarps ? kThreads / N : kWarps;" in src
    assert [_frames_per_block(n) for n in (3, 32, 35, 64)] == [8, 8, 7, 4]


@pytest.mark.parametrize("angle", EDGE_ANGLES, ids=["zero", "below", "above", "pi_z", "pi_xyz"])
def test_scalar_so3_formulas_match_rotation_ops(angle):
    """The kernel's scalar formulas against ops/rotation.py at the branch
    edges: R to 1e-15, J_l to f32 rounding of the f64 value."""
    r = torch.tensor(angle, dtype=torch.float64)
    np.testing.assert_allclose(
        np.array(_so3_exp_scalar(angle)), so3_exp(r).numpy(), rtol=0, atol=1e-15
    )
    np.testing.assert_allclose(
        np.array(_left_jacobian_scalar(angle)),
        so3_left_jacobian(r).numpy(), rtol=0, atol=6e-8,
    )


@pytest.mark.parametrize("loss_linear", [False, True], ids=["soft_l1", "linear"])
@pytest.mark.parametrize(
    "shape", [(5, 23, 0, 8), (3, 61, 6, 64)], ids=["ragged23", "padded61+6"]
)
def test_kernel_order_emulation_matches_twin_and_pallas(shape, loss_linear):
    """The emulation of the CUDA kernel's tiling and sums, with the packs
    from the scalar formulas at edge angles, against the plain twin and the
    JAX Pallas kernel (interpret mode) at this file's tolerances; padded
    frames stay exactly 0."""
    C_, F_, pad, tile_f = shape
    p = [x.numpy() for x in _problem("cpu", C_, F_, seed=5, pad=pad, edge_angles=True)]
    cam, poses, obs, mask, objp = (torch.as_tensor(x) for x in p)
    prepared = ba_cuda.ba_prepare_obs(obs, mask)
    emu = [x.double().numpy() for x in _emulated_blocks(
        cam, poses, *prepared, objp, loss_linear=loss_linear)]
    for name, x in zip(("U", "V", "W", "g_cam", "g_pose", "cost"), emu):
        assert np.isfinite(x).all(), name
    if pad:
        assert np.abs(emu[1][F_:]).max() == 0.0
        assert np.abs(emu[2][:, F_:]).max() == 0.0
        assert np.abs(emu[5][:, F_:]).max() == 0.0
    twin = _port(tlm.ba_chunk_blocks_reference, p, loss_linear=loss_linear)
    _assert_blocks_close(emu, twin)
    _assert_blocks_close(emu, _jax_blocks(p, tile_f=tile_f, loss_linear=loss_linear))
