"""Calibration initialization of the port vs the JAX package.

Same seeded numpy inputs through both packages, f64 on the CPU. The rig is
the JAX package's repair-test rig (tests/test_calibration.py:231-233: 4
cameras x 60 frames, noise 0.2 px, dropout 0.1, seed 5), 30 intrinsics
samples. Tolerances:

- closed forms (homographies, Zhang K, the fixed-principal-point K, planar
  poses, the twin pose, pairwise transforms, medians, reprojection errors):
  the same formulas through other LAPACK calls and sum orders, rtol 1e-9
  (poses from an SVD: 1e-8);
- iterated solves (the 10-step pose Gauss-Newton, the intrinsics LM):
  rtol 1e-7 on what they return, atol 1e-6 px / 1e-6 for distortion;
- ``calibrate`` end to end: the same spanning tree and NaN pattern,
  intrinsics rtol 1e-7, distortion atol 1e-6, extrinsics and poses atol
  1e-5 (rad, mm) on this rig.

The planar-pose Gauss-Newton is undamped: on some frames it leaves the
converged basin (RMS error >= 5 px, or |r| ~ 1e5) or lands in the other
planar basin, and which pose it returns there depends on the last bits of
every operation, so no two implementations (nor a GPU and a CPU) return the
same one. This rig has no such frame. The bench rig (6 x 1000, seed 11) has
47 of its 4552 seen camera-frames (46 on camera 3, 1 on camera 2): those of
``pose_unstable`` in data/bench_ba_ref.npz, where the JAX package's own
pose has left the basin or moves by more than 1e-4 when the detections or
the camera matrix are scaled by 1 +- 1e-15.
``test_bench_rig_poses_match_jax_off_its_unstable_frames`` shows that they
are the only difference: elsewhere the per-camera poses agree at rtol 1e-7,
and from JAX's per-camera poses the port's extrinsics chain and consensus
give JAX's calibrate outputs at 1e-9. Such poses enter the pairwise
medians (camera 3's extrinsics move by ~1e-4 rad, ~1 mm) and the consensus
medians of the frames camera 3 sees. ``test_calibrate_reproduces_the_bench_start``
holds the port's calibrate to JAX's stored bench start through
``chip_smoke.start_gates``, which ``chip_smoke.py`` phase 10 applies on the
card: the same tree, every intrinsic within 1e-6 relative (they use only
fully detected frames and no median), extrinsics equal (1e-6) but for the
cameras such poses can reach, those within 2e-3 rad and 10 mm (measured on
the CPU 1.1e-4 rad and 1.2 mm), the bench frames' poses equal (1e-6) but for
frames seen by a moved camera or holding an unstable pose, and the bench
problem's cost at the port's start within 1.5e-3 of the cost at JAX's
(measured 5.6e-4 on the CPU).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import multicam_calibration_tpu as jmct
from multicam_calibration_tpu.models import initialize as ji
from multicam_calibration_tpu_torch.models import initialize as ti
from multicam_calibration_tpu_torch.models import lm_core as tlm
from multicam_calibration_tpu_torch.models.bundle_adjustment import _params_to_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "multicam_calibration_tpu_torch", "data")
N_SAMPLES = 30
CPU = "cpu"


@pytest.fixture(scope="module")
def rig():
    return jmct.make_synthetic_rig(n_cameras=4, n_frames=60, noise_px=0.2, dropout=0.1, seed=5)


@pytest.fixture(scope="module")
def jax_cal(rig):
    return jmct.calibrate(rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
                          verbose=False, n_samples_for_intrinsics=N_SAMPLES)


@pytest.fixture(scope="module")
def sample(rig):
    """Camera 1's first 20 fully detected frames: (uvs, valid mask)."""
    uv = rig.all_calib_uvs[1]
    ixs = np.nonzero(~np.isnan(uv).any((1, 2)))[0][:20]
    valid = np.ones(len(ixs), bool)
    valid[-2:] = False  # two weight-0 frames
    return uv[ixs], valid


def _close(got, ref, rtol, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _homographies(rig, sample):
    uvs, valid = sample
    Ht, _ = ti.estimate_board_homographies(
        torch.as_tensor(uvs), torch.as_tensor(rig.calib_objpoints), torch.as_tensor(valid))
    Hj, _ = ji.estimate_board_homographies(
        jnp.asarray(uvs), jnp.asarray(rig.calib_objpoints), jnp.asarray(valid))
    return Ht, Hj


def test_homographies_and_closed_form_intrinsics_match_jax(rig, sample):
    Ht, Hj = _homographies(rig, sample)
    _close(Ht, Hj, 1e-9, 1e-12)
    valid = sample[1]
    _close(ti.intrinsics_from_homographies(Ht, torch.as_tensor(valid)),
           ji.intrinsics_from_homographies(Hj, jnp.asarray(valid)), 1e-9, 1e-9)
    size = rig.img_sizes[1]
    _close(ti.intrinsics_from_homographies_fixed_pp(Ht, torch.as_tensor(valid), size),
           ji.intrinsics_from_homographies_fixed_pp(Hj, jnp.asarray(valid), size), 1e-9)


def test_closed_forms_are_sign_free(rig, sample, monkeypatch):
    """The eigenvector's sign (fixed by B11 > 0) and the SVD's paired signs
    (cancelled by the det correction) do not reach K or the poses."""
    Ht, _ = _homographies(rig, sample)
    valid = torch.as_tensor(sample[1])
    K = ti.intrinsics_from_homographies(Ht, valid)
    poses = ti.poses_from_homographies(Ht, K)
    eigh, svd = torch.linalg.eigh, torch.linalg.svd

    def eigh_flipped(M):
        w, v = eigh(M)
        return w, -v

    def svd_flipped(M):
        U, S, Vt = svd(M)
        flip = torch.tensor([-1.0, 1.0, -1.0], dtype=M.dtype)
        return U * flip, S, Vt * flip[:, None]

    monkeypatch.setattr(torch.linalg, "eigh", eigh_flipped)
    monkeypatch.setattr(torch.linalg, "svd", svd_flipped)
    assert torch.equal(ti.intrinsics_from_homographies(Ht, valid), K)
    _close(ti.poses_from_homographies(Ht, K), poses, 0, 1e-12)


def test_intrinsics_field_valid_matches_jax(rig):
    size = rig.img_sizes[0]
    for cam6 in ([900, 905, 640, 512, -0.2, 0.03], [900, 900, 640, 512, -0.9, 0.1],
                 [3000, 1.4e6, 657, 461, -12.5, 925.9], [-5, 900, 640, 512, 0, 0],
                 [900, np.nan, 640, 512, 0, 0]):
        assert ti._intrinsics_field_valid(cam6, size) == ji._intrinsics_field_valid(cam6, size)


def test_planar_poses_gauss_newton_and_twin_match_jax(rig, sample):
    Ht, Hj = _homographies(rig, sample)
    K = rig.all_intrinsics[1][0]
    p0t = ti.poses_from_homographies(Ht, torch.as_tensor(K))
    p0j = ji.poses_from_homographies(Hj, jnp.asarray(K))
    _close(p0t, p0j, 1e-8, 1e-9)
    twin_t, twin_j = ti._twin_planar_pose(p0t), ji._twin_planar_pose(jnp.asarray(p0t.numpy()))
    _close(twin_t, twin_j, 1e-9, 1e-12)
    uvs, _ = sample
    cam12 = np.r_[K[0, 0], K[1, 1], K[0, 2], K[1, 2], rig.all_intrinsics[1][1][:2], np.zeros(6)]
    m = np.ones(uvs.shape[:2], bool)
    m[3] = False  # an unseen frame: masked rows, zero residual
    for start in (p0t.numpy(), twin_t.numpy()):
        got = ti._refine_poses_gn(torch.as_tensor(start), torch.as_tensor(cam12),
                                  torch.as_tensor(uvs), torch.as_tensor(m),
                                  torch.as_tensor(rig.calib_objpoints))
        ref = ji._refine_poses_gn(jnp.asarray(start), jnp.asarray(cam12), jnp.asarray(uvs),
                                  jnp.asarray(m), jnp.asarray(rig.calib_objpoints))
        ok = np.arange(len(m)) != 3
        _close(got[ok], np.asarray(ref)[ok], 1e-7, 1e-7)


@pytest.fixture(scope="module")
def jax_poses(rig):
    """JAX's per-camera poses (C, F, 6) at the true intrinsics."""
    Ks = [k for k, _ in rig.all_intrinsics]
    ds = [d for _, d in rig.all_intrinsics]
    return np.asarray(ji.estimate_pose_batch(rig.all_calib_uvs, rig.calib_objpoints, Ks, ds))


def _frame_rms(rig, poses, c):
    """Per-frame RMS reprojection error (px) of camera c's poses."""
    K, d = rig.all_intrinsics[c]
    cam12 = torch.as_tensor(np.r_[K[0, 0], K[1, 1], K[0, 2], K[1, 2], d[:2], np.zeros(6)])
    pred = tlm._predict(cam12[None], torch.as_tensor(np.nan_to_num(poses)),
                        torch.as_tensor(rig.calib_objpoints))[0].numpy()
    return np.sqrt(((rig.all_calib_uvs[c] - pred) ** 2).sum(-1).mean(-1))


def test_estimate_pose_matches_jax(rig, jax_poses):
    """Every camera (NaN rows where the board is not fully detected), and
    the camera batch. Frames where JAX's Gauss-Newton converged (RMS < 5 px,
    |r| < 2 pi) agree; any other frame diverged in both packages."""
    Ks = [k for k, _ in rig.all_intrinsics]
    ds = [d for _, d in rig.all_intrinsics]
    batch = ti.estimate_pose_batch(rig.all_calib_uvs, rig.calib_objpoints, Ks, ds, device=CPU)
    assert batch.shape == jax_poses.shape == (4, 60, 6)
    np.testing.assert_array_equal(np.isnan(batch.numpy()), np.isnan(jax_poses))
    for c in range(4):
        seen = ~np.isnan(jax_poses[c, :, 0])
        conv_j, conv_t = (
            (_frame_rms(rig, p, c) < 5.0) & (np.linalg.norm(p[:, :3], axis=-1) < 2 * np.pi)
            for p in (jax_poses[c], batch[c].numpy())
        )
        ok = seen & conv_j
        assert ok.sum() >= 0.9 * seen.sum()
        _close(batch[c].numpy()[ok], jax_poses[c][ok], 1e-7, 1e-7)
        assert not (seen & ~conv_j & conv_t).any()  # diverged in both
    for c in (0, 3):
        one = ti.estimate_pose(rig.all_calib_uvs[c], rig.calib_objpoints, Ks[c], ds[c],
                               device=CPU)
        assert torch.equal(torch.nan_to_num(one), torch.nan_to_num(batch[c]))


def _assert_intrinsics_close(got, ref):
    for (Kt, dt), (Kj, dj) in zip(got, ref):
        _close(Kt, Kj, 1e-7)
        _close(dt, dj, 0, 1e-6)


def test_get_intrinsics_matches_jax(rig):
    for c in (0, 2):
        got = ti.get_intrinsics(rig.all_calib_uvs[c], rig.calib_objpoints, rig.img_sizes[c],
                                n_samples=N_SAMPLES, device=CPU)
        ref = ji.get_intrinsics(rig.all_calib_uvs[c], rig.calib_objpoints, rig.img_sizes[c],
                                n_samples=N_SAMPLES)
        _assert_intrinsics_close([got], [ref])


def test_get_intrinsics_batch_matches_jax_batched_and_sequential(rig):
    """The port loops over cameras; JAX vmaps the LM (finished lanes held),
    so each camera's batched result is its sequential one in both."""
    args = (rig.all_calib_uvs, rig.calib_objpoints, rig.img_sizes)
    got = ti.get_intrinsics_batch(*args, n_samples=N_SAMPLES, device=CPU)
    _assert_intrinsics_close(got, ji.get_intrinsics_batch(*args, n_samples=N_SAMPLES))
    sequential = [ji.get_intrinsics(rig.all_calib_uvs[c], rig.calib_objpoints,
                                    rig.img_sizes[c], n_samples=N_SAMPLES) for c in range(4)]
    _assert_intrinsics_close(got, sequential)
    with pytest.raises(ValueError, match="camera 1"):
        few = rig.all_calib_uvs.copy()
        few[1, 2:] = np.nan
        ti.get_intrinsics_batch(few, rig.calib_objpoints, rig.img_sizes, device=CPU)


def test_extrinsics_chain_and_consensus_match_jax(rig, jax_poses):
    """From the same per-camera poses (JAX's): tree, pairwise medians, the
    chained extrinsics, the consensus poses and the reprojection errors."""
    Ks = [k for k, _ in rig.all_intrinsics]
    ds = [d for _, d in rig.all_intrinsics]
    poses = jax_poses
    assert ti.get_camera_spanning_tree(poses) == ji.get_camera_spanning_tree(poses)
    assert ti.get_camera_spanning_tree(poses, root=2) == ji.get_camera_spanning_tree(poses, root=2)
    _close(ti.estimate_pairwise_camera_transform(poses[0], poses[1], device=CPU),
           ji.estimate_pairwise_camera_transform(poses[0], poses[1]), 1e-9, 1e-9)
    ext_t, tree_t = ti.estimate_all_extrinsics(poses, device=CPU)
    ext_j, tree_j = ji.estimate_all_extrinsics(poses)
    assert tree_t == tree_j
    _close(ext_t, ext_j, 1e-9, 1e-9)
    cons_t = ti.consensus_calib_poses(poses, ext_j, device=CPU).numpy()
    cons_j = np.asarray(ji.consensus_calib_poses(poses, ext_j))
    np.testing.assert_array_equal(np.isnan(cons_t), np.isnan(cons_j))
    _close(np.nan_to_num(cons_t), np.nan_to_num(cons_j), 1e-9, 1e-9)
    for c in range(4):
        assert np.isclose(
            ti._rig_consistent_err(rig.all_calib_uvs[c], ext_j[c], Ks[c], ds[c], cons_j,
                                   rig.calib_objpoints, torch.device(CPU)),
            ji._rig_consistent_err(rig.all_calib_uvs[c], ext_j[c], Ks[c], ds[c], cons_j,
                                   rig.calib_objpoints), rtol=1e-9)


def _assert_calibration_close(got, ref):
    ext_t, intr_t, poses_t, tree_t = got
    ext_j, intr_j, poses_j, tree_j = ref
    assert tree_t == tree_j
    _assert_intrinsics_close(intr_t, intr_j)
    _close(ext_t, ext_j, 0, 1e-5)
    np.testing.assert_array_equal(np.isnan(poses_t), np.isnan(poses_j))
    _close(np.nan_to_num(poses_t), np.nan_to_num(poses_j), 0, 1e-5)


def test_calibrate_matches_jax(rig, jax_cal):
    got = ti.calibrate(rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints, verbose=False,
                       n_samples_for_intrinsics=N_SAMPLES, device=CPU)
    assert isinstance(got[0], np.ndarray) and isinstance(got[2], np.ndarray)
    assert all(isinstance(K, np.ndarray) and K.shape == (3, 3) for K, _ in got[1])
    _assert_calibration_close(got, jax_cal)


def test_calibrate_batched_route_matches_jax(rig, monkeypatch):
    """The accelerator route (``get_intrinsics_batch`` + ``estimate_pose_batch``),
    which both packages take off the CPU, forced in both on the CPU: the
    port's calibrate equals JAX's at the end-to-end tolerances above, and
    its own per-camera route."""

    class _OffCpu:  # the JAX module's ``jax`` with a non-CPU default backend
        def __getattr__(self, name):
            import jax

            return (lambda: "gpu") if name == "default_backend" else getattr(jax, name)

    seen = []
    monkeypatch.setattr(ti, "_batched_route",
                        lambda uvs, dev: seen.append(dev.type) or uvs.ndim == 4)
    monkeypatch.setattr(ji, "jax", _OffCpu())
    calls = {}
    for module, who in ((ti, "torch"), (ji, "jax")):
        for name in ("get_intrinsics_batch", "estimate_pose_batch"):
            real, key = getattr(module, name), f"{who}.{name}"
            calls[key] = 0
            monkeypatch.setattr(module, name, lambda *a, _r=real, _k=key, **kw: (
                calls.__setitem__(_k, calls[_k] + 1), _r(*a, **kw))[1])
    args = (rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints)
    ref = jmct.calibrate(*args, verbose=False, n_samples_for_intrinsics=N_SAMPLES)
    got = ti.calibrate(*args, verbose=False, n_samples_for_intrinsics=N_SAMPLES, device=CPU)
    assert seen == ["cpu"] and set(calls.values()) == {1}
    _assert_calibration_close(got, ref)
    monkeypatch.setattr(ti, "_batched_route", lambda uvs, dev: False)
    _assert_calibration_close(ti.calibrate(*args, verbose=False,
                                           n_samples_for_intrinsics=N_SAMPLES, device=CPU), ref)
    assert not ti._batched_route(np.asarray(rig.all_calib_uvs), torch.device("cpu"))


def test_repair_bad_intrinsics_matches_jax(rig, monkeypatch, capsys):
    """Camera 3 (a leaf) comes out of the intrinsics stage with fx 35% off
    (as tests/test_calibration.py:222-258 corrupts it); both packages flag
    and repair the same camera to the same intrinsics."""

    def corrupting(module):
        real = module.get_intrinsics

        def get_intrinsics(calib_uvs, *args, seed=0, **kwargs):
            K, d = real(calib_uvs, *args, seed=seed, **kwargs)
            if seed == 0 and np.array_equal(np.asarray(calib_uvs), rig.all_calib_uvs[3],
                                            equal_nan=True):
                K = np.array(K)
                K[0, 0] *= 1.35
            return K, d

        monkeypatch.setattr(module, "get_intrinsics", get_intrinsics)

    corrupting(ji)
    corrupting(ti)
    args = (rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints)
    ref = ji.calibrate(*args, verbose=True, n_samples_for_intrinsics=N_SAMPLES)
    jax_out = capsys.readouterr().out
    got = ti.calibrate(*args, verbose=True, n_samples_for_intrinsics=N_SAMPLES, device=CPU)
    port_out = capsys.readouterr().out
    repaired = [ln.split(":")[0].strip() for ln in jax_out.splitlines() if "repaired camera" in ln]
    assert repaired == ["repaired camera 3"]
    assert [ln.split(":")[0].strip() for ln in port_out.splitlines()
            if "repaired camera" in ln] == repaired
    true_fx = rig.all_intrinsics[3][0][0, 0]
    assert abs(got[1][3][0][0, 0] - true_fx) < 0.05 * true_fx
    _assert_calibration_close(got, ref)


@pytest.fixture(scope="module")
def bench():
    """The bench rig (bench.py:71-81) and the JAX package's stored answers
    for it (data/bench_ba_ref.npz, data/bench_x0.npz)."""
    rig = jmct.make_synthetic_rig(n_cameras=6, n_frames=1000, noise_px=0.3, dropout=0.25,
                                  seed=11)
    return (rig, np.load(os.path.join(DATA, "bench_ba_ref.npz")),
            np.load(os.path.join(DATA, "bench_x0.npz")))


def test_bench_rig_poses_match_jax_off_its_unstable_frames(bench):
    """At JAX's bench intrinsics: every camera's planar poses equal JAX's
    (rtol 1e-7, atol 1e-7) on each seen camera-frame outside
    ``pose_unstable`` (recomputed here from the JAX package, 1% of the seen
    camera-frames); from JAX's per-camera poses the port's extrinsics chain
    and consensus give JAX's calibrate outputs (atol 1e-9)."""
    spec = importlib.util.spec_from_file_location(
        "export_torch_bench_ba", os.path.join(ROOT, "scripts", "export_torch_bench_ba.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    rig, ref, _ = bench
    intr = list(zip(ref["K"], ref["dist"]))
    unstable = export.pose_unstable(rig, intr)
    np.testing.assert_array_equal(unstable, ref["pose_unstable"])
    Ks, ds = list(ref["K"]), list(ref["dist"])
    jp = np.asarray(ji.estimate_pose_batch(rig.all_calib_uvs, rig.calib_objpoints, Ks, ds))
    tp = ti.estimate_pose_batch(rig.all_calib_uvs, rig.calib_objpoints, Ks, ds,
                                device=CPU).numpy()
    np.testing.assert_array_equal(np.isnan(tp), np.isnan(jp))
    seen = ~np.isnan(jp[..., 0])
    assert not (unstable & ~seen).any() and 0 < unstable.sum() <= 0.015 * seen.sum()
    stable = seen & ~unstable
    _close(tp[stable], jp[stable], 1e-7, 1e-7)
    ext, tree = ti.estimate_all_extrinsics(jp, device=CPU)
    assert tree == [tuple(e) for e in ref["tree"].tolist()]
    _close(ext, ref["ext"], 0, 1e-9)
    cons = ti.consensus_calib_poses(jp, ref["ext"], device=CPU).numpy()
    np.testing.assert_array_equal(np.isnan(cons), np.isnan(ref["poses"]))
    _close(np.nan_to_num(cons), np.nan_to_num(ref["poses"]), 0, 1e-9)


def test_calibrate_reproduces_the_bench_start(bench):
    """The port's calibrate on the bench rig against the JAX package's,
    through chip_smoke.py phase 10's gates (tolerances in the module
    docstring)."""
    import chip_smoke

    rig, ref, x0 = bench
    np.testing.assert_array_equal(x0["cam0"], _params_to_arrays(
        ref["ext"], list(zip(ref["K"], ref["dist"]))))
    cal = ti.calibrate(rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints, verbose=False,
                       n_samples_for_intrinsics=50, device=CPU)
    chip_smoke.start_gates(torch, torch.device(CPU), rig, cal, ref, x0)
