"""``calibrate(reanchor=True)``, the port-side option that the 64-camera
stage's calibration turns on, on the CPU. It is off by default, where the
results are the JAX package's (the parity tests hold that); here it does
what it is for: every camera's extrinsics from its own board poses against
the consensus poses, in place of the chain along the spanning tree, which
hands one camera's error to the cameras below it; and a camera the repair
flags resected against the consensus poses before it is refit from fresh
samples.
"""
import numpy as np
import pytest
import torch

import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu_torch.models import initialize as ti
from multicam_calibration_tpu_torch.ops.transforms import (get_transformation_matrix,
                                                          get_transformation_vector)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rig():
    return tmct.make_synthetic_rig(4, 40, noise_px=0.3, dropout=0.2, seed=7)


def _stage(n_cameras, n_frames, seed, noise=0.0):
    """Extrinsics (C, 6), world board poses (F, 6) and the board -> camera
    poses they make (C, F, 6), with N(0, ``noise``) on every pose entry."""
    rng = np.random.default_rng(seed)
    ext = np.concatenate([rng.normal(0, 0.3, (n_cameras, 3)),
                          rng.normal(0, 200, (n_cameras, 3))], 1)
    ext[0] = 0.0
    world = np.concatenate([rng.normal(0, 0.5, (n_frames, 3)),
                            rng.normal(0, 100, (n_frames, 3))], 1)
    T = get_transformation_matrix(torch.as_tensor(ext))[:, None] @ get_transformation_matrix(
        torch.as_tensor(world))[None]
    poses = get_transformation_vector(T).numpy()
    return ext, world, poses + rng.normal(0, noise, poses.shape)


def test_reanchor_recovers_exact_extrinsics():
    """Poses made exactly from extrinsics and world poses give those
    extrinsics back; the root keeps its row, and a camera with no frame in
    common with the consensus keeps the row it was given."""
    ext, world, poses = _stage(4, 30, seed=3)
    poses[1, ::3] = np.nan  # unseen frames
    poses[3] = np.nan  # a camera that shares no frame
    given = ext + 1.0
    got = ti._reanchor_extrinsics(poses, world, given, 0, CPU)
    np.testing.assert_array_equal(got[0], given[0])
    np.testing.assert_allclose(got[1:3], ext[1:3], atol=1e-9)
    np.testing.assert_array_equal(got[3], given[3])


def test_reanchor_removes_a_chained_error():
    """A 50 mm error on camera 2's chained extrinsics, as a poorly
    initialised parent in the tree hands its children, moves the consensus
    poses little (a median over 12 cameras) and is gone after re-anchoring
    to them."""
    ext, _, poses = _stage(12, 40, seed=5, noise=1e-3)
    chained = ext.copy()
    chained[2, 3] += 50.0
    consensus = ti._host(tmct.consensus_calib_poses(poses, chained, device=CPU))
    got = ti._reanchor_extrinsics(poses, consensus, chained, 0, CPU)
    assert np.abs(got[:, 3:] - ext[:, 3:]).max() < 0.1
    np.testing.assert_array_equal(got[0], chained[0])


@pytest.mark.parametrize("reanchor", [False, True])
def test_calibrate_reanchors_after_the_consensus(rig, monkeypatch, reanchor):
    """With ``reanchor`` the returned extrinsics are the last re-anchoring's
    and the consensus poses are taken at them; without, no re-anchoring runs."""
    real = ti._reanchor_extrinsics
    seen = []

    def spy(*args):
        seen.append((args[0], real(*args)))
        return seen[-1][1]

    monkeypatch.setattr(ti, "_reanchor_extrinsics", spy)
    ext, _, cons, _ = tmct.calibrate(rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
                                     verbose=False, n_samples_for_intrinsics=15, device=CPU,
                                     reanchor=reanchor)
    assert bool(seen) is reanchor  # once, and once more after a repair
    if reanchor:
        poses, last = seen[-1]
        np.testing.assert_array_equal(ext, last)
        np.testing.assert_array_equal(
            cons, ti._host(tmct.consensus_calib_poses(poses, ext, device=CPU)))


def _rotation_gap(a, b):
    """Angle (rad) between the rotations of two 6-vector extrinsics."""
    R = get_transformation_matrix(torch.as_tensor(np.stack([a, b])))[:, :3, :3]
    c = (torch.trace(R[0] @ R[1].T) - 1) / 2
    return float(torch.arccos(torch.clamp(c, -1, 1)))


def test_resection_recovers_a_compensating_fit():
    """A camera whose focal length, distortion and extrinsics are far off
    (a single-camera fit that traded focal length for distortion) comes
    back to the truth when resected against the true board poses."""
    rig = tmct.make_synthetic_rig(4, 80, noise_px=0.3, dropout=0.2, seed=2)
    K, d = rig.all_intrinsics[1]
    K_bad = K.copy()
    K_bad[0, 0] *= 0.7
    K_bad[1, 1] *= 0.7
    ext_bad = rig.all_extrinsics[1] + np.array([0.05, -0.03, 0.02, 20.0, -15.0, 10.0])
    (K_got, _), ext_got = ti._resect_camera(rig.all_calib_uvs[1], ext_bad, K_bad,
                                             np.array([-1.0, 3.0, 0, 0, 0]), rig.calib_poses,
                                             rig.calib_objpoints, CPU)
    np.testing.assert_allclose(K_got[[0, 1], [0, 1]], K[[0, 1], [0, 1]], rtol=5e-3)
    assert _rotation_gap(ext_got, rig.all_extrinsics[1]) < 2e-3
    assert np.linalg.norm(ext_got[3:] - rig.all_extrinsics[1, 3:]) < 5.0


@pytest.mark.parametrize("resect", [False, True])
def test_repair_resects_a_flagged_camera(monkeypatch, resect):
    """Camera 2's intrinsics a compensating fit, the rest of the rig true:
    the repair flags camera 2, resects it against the consensus poses first
    with ``resect`` (which brings its focal length back without a refit
    from samples), and refits it from samples alone without."""
    rig = tmct.make_synthetic_rig(5, 60, noise_px=0.3, dropout=0.2, seed=2)
    intr = [(K.copy(), d.copy()) for K, d in rig.all_intrinsics]
    intr[2][0][:2, :2] *= 0.7
    intr[2][1][:2] = (-1.0, 3.0)
    T = get_transformation_matrix(torch.as_tensor(rig.all_extrinsics))[:, None] @ \
        get_transformation_matrix(torch.as_tensor(rig.calib_poses))[None]
    poses = get_transformation_vector(T).numpy()
    real_resect, real_get = ti._resect_camera, ti.get_intrinsics
    resected, refits = [], []
    monkeypatch.setattr(ti, "_resect_camera",
                        lambda *a: resected.append(1) or real_resect(*a))
    monkeypatch.setattr(ti, "get_intrinsics",
                        lambda *a, **k: refits.append(1) or real_get(*a, **k))
    changed = ti._repair_bad_intrinsics(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints, intr, poses,
        rig.all_extrinsics, rig.calib_poses, 30, False, CPU, resect=resect)
    assert changed
    assert len(resected) == int(resect)
    assert bool(refits) is not resect
    np.testing.assert_allclose(intr[2][0][0, 0], rig.all_intrinsics[2][0][0, 0],
                               rtol=5e-3 if resect else 0.05)
