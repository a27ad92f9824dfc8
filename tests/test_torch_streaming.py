"""RollingCalibrator: the port against the JAX package, f64 on the CPU.

One stream of seeded batches goes through both packages from the same
drifted start (tests/test_streaming.py's rig and drift): 4 cameras, window
24, ``protect_recent`` 8, batches of 6 (not a power of two; JAX pads them to
8 and drops the padding, the port scatters only the admitted rows), the 5th
update evicting, the 6th a batch of 36 (larger than the window), the 7th a
batch of 7. Every update compares:

- ``admitted``, ``occupancy``, ``n_iters``, the window's slots (arrival
  order) and visibility: equal (the eviction decisions);
- the cost within 1e-9 relative;
- the cameras within 1e-8 relative, gauge-free: with the intrinsics frozen
  every camera's extrinsics are free, so the rig's absolute pose is a
  6-dof null direction of the solve, along which rounding moves both
  packages differently (~1e-4 after a few updates at equal cost); the
  relative extrinsics (each camera to camera 0) carry the calibration.

``convert.rolling_state_from_jax`` carries JAX's state after the 4th update
over, and one update from it matches JAX's 5th. The camera-batched pose
init equals the per-camera loop. The f32 recipe is chosen by the device:
on CUDA only, rehearsed here with the kernel routes patched to take CPU
tensors.
"""
import numpy as np
import pytest
import torch

from multicam_calibration_tpu.models import streaming as jstream
from multicam_calibration_tpu.models.streaming import RollingCalibrator as JRolling
import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu_torch import convert
from multicam_calibration_tpu_torch.models import initialize as tinit
from multicam_calibration_tpu_torch.models import lm_core as tlm
from multicam_calibration_tpu_torch.models import streaming as tstream
from multicam_calibration_tpu_torch.synthetic import _T_to_t6, _t6_to_T

COST_RTOL, CAM_RTOL = 1e-9, 1e-8
KW = dict(window=24, iters_per_update=3, protect_recent=8)
BATCHES = [(0, 6), (6, 12), (12, 18), (18, 24), (24, 30), (30, 66), (66, 73)]
CARRY_AFTER = 4  # rolling_state_from_jax: JAX's state after this many updates


def relative_extrinsics(ext):
    T0_inv = np.linalg.inv(_t6_to_T(np.asarray(ext)[0]))
    return np.stack([_T_to_t6(_t6_to_T(e) @ T0_inv) for e in np.asarray(ext)])


def _state(cal):
    """What each update decides and produces."""
    return dict(ext=cal.calibration()[0], order=np.array(cal._order),
                seen=np.array(cal._seen2d), next=cal._next_arrival)


@pytest.fixture(scope="module")
def streams():
    rig = tmct.make_synthetic_rig(4, 96, noise_px=0.3, dropout=0.15, seed=21)
    rng = np.random.default_rng(0)
    ext = rig.all_extrinsics.copy()
    ext[:, :3] += rng.normal(0, 0.005, (4, 3))
    ext[:, 3:] += rng.normal(0, 3.0, (4, 3))
    ext[0] = rig.all_extrinsics[0]
    intr = [(K.copy(), d.copy()) for K, d in rig.all_intrinsics]
    jcal = JRolling(ext, intr, rig.calib_objpoints, **KW)
    tcal = tmct.RollingCalibrator(ext, intr, rig.calib_objpoints, device="cpu", **KW)
    rows, carried = [], None
    for k, (lo, hi) in enumerate(BATCHES):
        if k == CARRY_AFTER:
            # Copies: the next update mutates _seen2d and _order in place.
            carried = {n: (getattr(jcal, n) if n in ("_intr", "_lam")
                           else np.array(getattr(jcal, n)))
                       for n in convert.ROLLING_STATE}
        batch = rig.all_calib_uvs[:, lo:hi]
        j_info, t_info = jcal.update(batch), tcal.update(batch)
        rows.append((j_info, _state(jcal), t_info, _state(tcal)))
    return rig, rows, carried


@pytest.mark.parametrize("k", range(len(BATCHES)))
def test_update_matches_jax(streams, k):
    _, rows, _ = streams
    j_info, j, t_info, t = rows[k]
    for key in ("admitted", "occupancy", "n_iters"):
        assert t_info[key] == j_info[key], key
    np.testing.assert_array_equal(t["order"], j["order"])
    np.testing.assert_array_equal(t["seen"], j["seen"])
    assert t["next"] == j["next"]
    np.testing.assert_allclose(t_info["cost"], j_info["cost"], rtol=COST_RTOL)
    np.testing.assert_allclose(relative_extrinsics(t["ext"]), relative_extrinsics(j["ext"]),
                               rtol=CAM_RTOL, atol=CAM_RTOL)


def test_stream_covers_eviction_and_oversized_batches(streams):
    _, rows, _ = streams
    admitted = [r[2]["admitted"] for r in rows]
    assert admitted[5] == KW["window"]  # 36 frames offered, the newest 24 kept
    assert all(r[2]["occupancy"] == KW["window"] for r in rows[3:])
    assert len({hi - lo for lo, hi in BATCHES} & {6, 7}) == 2  # not powers of two


def test_update_from_jax_state_matches_jax(streams):
    rig, rows, carried = streams
    cal = convert.rolling_state_from_jax(carried, rig.calib_objpoints, device="cpu",
                                         iters_per_update=KW["iters_per_update"],
                                         protect_recent=KW["protect_recent"])
    assert cal.n_updates == CARRY_AFTER and cal.occupancy == rows[CARRY_AFTER - 1][2]["occupancy"]
    lo, hi = BATCHES[CARRY_AFTER]
    info = cal.update(rig.all_calib_uvs[:, lo:hi])
    j_info, j, _, _ = rows[CARRY_AFTER]
    assert info == {**j_info, "cost": info["cost"]}
    np.testing.assert_allclose(info["cost"], j_info["cost"], rtol=COST_RTOL)
    np.testing.assert_array_equal(cal._order, j["order"])
    np.testing.assert_allclose(relative_extrinsics(cal.calibration()[0]),
                               relative_extrinsics(j["ext"]), rtol=CAM_RTOL, atol=CAM_RTOL)
    with pytest.raises(ValueError, match="lacks"):
        convert.rolling_state_from_jax({"_ext": carried["_ext"]}, rig.calib_objpoints)


def test_batched_pose_init_equals_the_camera_loop_and_jax(streams):
    """(C, B, N, 2) at once equals the per-camera _estimate_pose_impl (bit
    for bit on the CPU) and JAX's jit(vmap(...)) (rtol 1e-8)."""
    rig, _, _ = streams
    uvs = rig.all_calib_uvs[:, 40:47]
    Ks = np.stack([K for K, _ in rig.all_intrinsics])
    ds = np.stack([d for _, d in rig.all_intrinsics])
    args = [torch.as_tensor(a) for a in (uvs, Ks, ds, rig.calib_objpoints)]
    got = tinit._batched_estimate_pose(*args)
    loop = torch.stack([tinit._estimate_pose_impl(args[0][c], args[1][c], args[2][c], args[3])
                        for c in range(len(Ks))])
    assert got.shape == (4, 7, 6)
    assert torch.equal(got.isnan(), loop.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(loop))
    want = np.asarray(jstream._batched_estimate_pose(uvs, Ks, ds, rig.calib_objpoints))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-9, equal_nan=True)


def test_recipe_is_chosen_by_the_device():
    f64, f32 = torch.float64, torch.float32
    cuda = tstream._window_options(f64, torch.device("cuda"), 3)
    cpu = tstream._window_options(f64, torch.device("cpu"), 3)
    assert cuda == tlm.LMOptions(
        max_iters=3, ftol=0.0, jac_dtype="float32", block_dtype="float32",
        cost_dtype="float32", solve_dtype="float32", grad_dtype="float32",
        lambda_escalation=3.0)
    assert cpu == tlm.LMOptions(max_iters=3, ftol=0.0)
    assert tstream._window_options(f32, torch.device("cuda"), 3) == tlm.LMOptions(
        max_iters=3, ftol=0.0)
    objp = torch.zeros(35, 3)
    assert tlm._cuda_block_build(cuda, f64, objp) is False  # CPU tensors never launch
    assert cuda.block_impl == cuda.cost_impl == "auto"


def test_update_on_the_recipe_routes_through_both_kernels(streams, monkeypatch):
    """The CUDA recipe with CPU tensors treated as CUDA: every iteration
    calls the block wrapper once and every cost evaluation the cost wrapper
    once (the twins run on the CPU)."""
    from multicam_calibration_tpu_torch.ops import ba_cuda

    rig, _, _ = streams
    calls = {"blocks": 0, "cost": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(tlm, "_route", lambda impl, name, ok, req, objp: impl != "torch" and ok)
    monkeypatch.setattr(ba_cuda, "ba_chunk_blocks",
                        counted("blocks", tlm.ba_chunk_blocks_reference))
    monkeypatch.setattr(ba_cuda, "ba_chunk_cost", counted("cost", tlm.ba_chunk_cost_reference))
    infos = []
    lm_solve = tstream.lm_solve
    monkeypatch.setattr(tstream, "lm_solve",
                        lambda *a, **k: infos.append(lm_solve(*a, **k)) or infos[-1])
    recipe = tstream._window_options(torch.float64, torch.device("cuda"), 3)
    cal = tmct.RollingCalibrator(rig.all_extrinsics, rig.all_intrinsics, rig.calib_objpoints,
                                 lm_options=recipe, device="cpu", window=24)
    for lo in (0, 6):
        before = dict(calls)
        info = cal.update(rig.all_calib_uvs[:, lo:lo + 6])
        solve = infos[-1][2]
        assert calls["blocks"] - before["blocks"] == solve["n_iters"] == info["n_iters"] == 3
        assert calls["cost"] - before["cost"] == solve["nfev"] >= 4
    assert cal._opts == recipe


def test_rolling_calibrator_defaults_to_the_card(streams, monkeypatch):
    rig, _, _ = streams
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmct.RollingCalibrator(rig.all_extrinsics, rig.all_intrinsics, rig.calib_objpoints)
    with pytest.raises(ValueError, match="expected 4 cameras"):
        tmct.RollingCalibrator(rig.all_extrinsics, rig.all_intrinsics, rig.calib_objpoints,
                               device="cpu").update(rig.all_calib_uvs[:3, :2])
