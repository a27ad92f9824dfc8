"""The port's public bundle-adjustment layer vs the JAX package.

Same seeded numpy problem through both packages on the CPU: a 4-camera,
60-frame rig (noise 0.3 px, dropout 0.25, seed 7) started from the truth
perturbed by a seeded 2e-3 (camera and pose parameters, fx/fy/cx/cy
relative). Tolerances:

- ``select_ba_frames``: the same frames (exact);
- ``residuals``: rtol 1e-12 (the same forward model in f64);
- ``bundle_adjust`` with default options on the CPU (f64 data, f32
  Jacobians in both packages): the same frames and iteration count, final
  cost rtol 1e-6 (the f32 Jacobian rows round differently, and both stop at
  ftol 1e-4);
- with the accelerator recipe (what the port applies on CUDA; given here as
  an ``lm_options`` dict, which JAX takes too): final cost rtol 1e-6 after
  the f64 polish in both;
- ``_repair_bad_poses`` on one corrupted frame: the same frame repaired,
  its pose within 1e-6 (rad, mm);
- checkpoint resume across packages: the same fingerprint, frames and
  iteration count, final cost rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import multicam_calibration_tpu as jmct
from multicam_calibration_tpu.models import bundle_adjustment as jba
from multicam_calibration_tpu.models import lm_core as jlm
import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu_torch.models import bundle_adjustment as tba
from multicam_calibration_tpu_torch.models import initialize as ti
from multicam_calibration_tpu_torch.models import lm_core as tlm

CPU = "cpu"
RECIPE = dict(block_dtype="float32", cost_dtype="float32", solve_dtype="float32",
              grad_dtype="float32", gtol_rel=1e-6, lambda_escalation=3.0)


@pytest.fixture(scope="module")
def problem():
    rig = jmct.make_synthetic_rig(n_cameras=4, n_frames=60, noise_px=0.3, dropout=0.25, seed=7)
    rng = np.random.default_rng(3)
    ext = rig.all_extrinsics + rng.normal(0, 2e-3, rig.all_extrinsics.shape)
    intr = []
    for K, d in rig.all_intrinsics:
        fx, fy, cx, cy = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]) * (
            1 + rng.normal(0, 2e-3, 4))
        intr.append((np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]), np.asarray(d)))
    poses = rig.calib_poses + rng.normal(0, 2e-3, rig.calib_poses.shape)
    return rig, (rig.all_calib_uvs, ext, intr, rig.calib_objpoints, poses)


@pytest.fixture(scope="module")
def jax_ba(problem):
    return jmct.bundle_adjust(*problem[1], verbose=False)


def _rmse(rig, out):
    ext, intr, poses, uf, _ = out
    pred = tba.predict_calib_uvs(ext, intr, rig.calib_objpoints, poses, device=CPU).numpy()
    err = np.linalg.norm(rig.all_calib_uvs[:, uf] - pred, axis=-1)
    return float(np.sqrt(np.nanmean(err**2)))


def test_bundle_adjust_matches_jax(problem, jax_ba):
    rig, args = problem
    got = tba.bundle_adjust(*args, verbose=False, device=CPU)
    ext, intr, poses, uf, info = got
    np.testing.assert_array_equal(uf, jax_ba[3])
    assert sorted(info) == sorted(jax_ba[4])
    assert all(isinstance(v, np.ndarray) for v in info.values())
    assert int(info["n_iters"]) == int(jax_ba[4]["n_iters"])
    np.testing.assert_allclose(float(info["final_cost"]), float(jax_ba[4]["final_cost"]),
                               rtol=1e-6)
    assert isinstance(ext, np.ndarray) and ext.shape == (4, 6) and poses.shape == (len(uf), 6)
    assert abs(_rmse(rig, got) - _rmse(rig, jax_ba)) <= 1e-6


def test_bundle_adjust_recipe_polishes_like_jax(problem, jax_ba):
    """The numerics the port applies on CUDA: a mixed f32 solve, then the f64
    polish on the same device (never a CPU hop)."""
    got = tba.bundle_adjust(*problem[1], verbose=False, device=CPU, lm_options=RECIPE)[4]
    ref = jmct.bundle_adjust(*problem[1], verbose=False, lm_options=RECIPE)[4]
    assert got["polish_on_cpu"] == ref["polish_on_cpu"] == np.asarray(False)
    assert int(got["polish_iters"]) >= 1
    np.testing.assert_allclose(float(got["final_cost"]), float(ref["final_cost"]), rtol=1e-6)
    assert float(got["final_cost"]) <= float(jax_ba[4]["final_cost"]) * (1 + 1e-5)


def test_select_ba_frames_matches_jax(problem):
    _, args = problem
    for kw in ({}, dict(n_frames=20, seed=3), dict(outlier_threshold=1.0)):
        got = tba.select_ba_frames(*args, verbose=False, device=CPU, **kw)
        np.testing.assert_array_equal(got, jba.select_ba_frames(*args, verbose=False, **kw))


def test_bundle_adjust_reads_back_no_detection_sized_array(problem):
    """The detections go to the device once: the selection, the preparation
    and the repair's flag read back per-frame vectors and scalars (the
    counter ``ba.readback_bytes``), never a (C, F, N, .) array."""
    from multicam_calibration_tpu_torch.utils.metrics import metrics

    uvs = problem[1][0]
    before = metrics.stage_times.get("ba.readback_bytes", 0)
    tba.bundle_adjust(*problem[1], verbose=False, device=CPU)
    read = metrics.stage_times["ba.readback_bytes"] - before
    assert 0 < read < uvs.size * 8 / 10


def test_residuals_and_sparsity_match_jax(problem):
    rig, (uvs, ext, intr, objp, poses) = problem
    x = tba.serialize_params(ext, intr, poses)
    got = tba.residuals(x, uvs, objp, device=CPU)
    np.testing.assert_allclose(got, jba.residuals(x, uvs, objp), rtol=1e-12, atol=1e-9)
    small = uvs[:, :8]
    A_t, A_j = tba.bundle_adjustment_sparsity(small), jba.bundle_adjustment_sparsity(small)
    assert A_t.shape == A_j.shape
    np.testing.assert_array_equal(A_t.toarray(), A_j.toarray())


def test_repair_bad_poses_matches_jax(problem, jax_ba):
    rig, (uvs, *_rest) = problem
    ext, intr, poses, uf, _ = jax_ba
    cam = tba._params_to_arrays(ext, intr)
    obs_np = uvs[:, uf]
    obs, mask = np.nan_to_num(obs_np), ~np.isnan(obs_np).any(-1)
    bad = 5
    poses = poses.copy()
    poses[bad, :3] += np.array([0.6, -0.4, 0.3])
    poses[bad, 3:] += 40.0
    p_t, n_t = tba._repair_bad_poses(*(torch.as_tensor(a) for a in (cam, poses, obs, mask)),
                                     torch.as_tensor(rig.calib_objpoints), tlm.LMOptions())
    p_j, n_j = jba._repair_bad_poses(*(jnp.asarray(a) for a in (cam, poses, obs, mask)),
                                     jnp.asarray(rig.calib_objpoints), jlm.LMOptions())
    assert n_t == n_j >= 1
    p_t, p_j = p_t.numpy(), np.asarray(p_j)
    changed = np.nonzero((p_t != poses).any(-1))[0]
    assert bad in changed
    np.testing.assert_array_equal(changed, np.nonzero((p_j != poses).any(-1))[0])
    np.testing.assert_allclose(p_t[changed], p_j[changed], rtol=0, atol=1e-6)


def _resume_both(problem, path, **kw):
    """Resume a checkpoint at ``path`` in each package (on its own copy)."""
    copy = path.replace(".npz", "_copy.npz")
    with open(path, "rb") as src, open(copy, "wb") as dst:
        dst.write(src.read())
    t = tba.bundle_adjust(*problem[1], verbose=False, device=CPU, checkpoint_path=path, **kw)
    j = jmct.bundle_adjust(*problem[1], verbose=False, checkpoint_path=copy, **kw)
    np.testing.assert_array_equal(t[3], j[3])
    assert int(t[4]["n_iters"]) == int(j[4]["n_iters"])
    np.testing.assert_allclose(float(t[4]["final_cost"]), float(j[4]["final_cost"]), rtol=1e-6)
    return t, j


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(problem, jax_ba, tmp_path, writer):
    """A run cut at 4 iterations by one package resumes in both: the same
    frames, iteration count and final cost as the uninterrupted run."""
    uvs = problem[1][0]
    assert tba._ba_fingerprint(uvs, 0, 10000, None) == jba._ba_fingerprint(uvs, 0, 10000, None)
    path = str(tmp_path / "ba.npz")
    if writer == "jax":
        jmct.bundle_adjust(*problem[1], verbose=False, checkpoint_path=path,
                           checkpoint_every=2, max_iters=4)
    else:
        tba.bundle_adjust(*problem[1], verbose=False, device=CPU, checkpoint_path=path,
                          checkpoint_every=2, max_iters=4)
    ck = np.load(path)
    assert int(ck["it_done"]) == 4 and str(ck["fingerprint"]) == jba._ba_fingerprint(
        uvs, 0, 10000, None)
    t, _ = _resume_both(problem, path, checkpoint_every=2)
    np.testing.assert_array_equal(t[3], jax_ba[3])
    assert int(t[4]["n_iters"]) >= 4


def test_checkpoint_refuses_another_problem(problem, tmp_path):
    path = str(tmp_path / "ba.npz")
    tba.bundle_adjust(*problem[1], verbose=False, device=CPU, checkpoint_path=path,
                      checkpoint_every=2, max_iters=2)
    with pytest.raises(ValueError, match="different problem"):
        tba.bundle_adjust(*problem[1], verbose=False, device=CPU, checkpoint_path=path, seed=1)
    with pytest.raises(ValueError, match="different problem"):
        jmct.bundle_adjust(*problem[1], verbose=False, checkpoint_path=path, seed=1)


def test_mesh_is_not_ported(problem, tmp_path):
    """``mesh`` is ported: on a mesh of one process bundle_adjust equals the
    run without one (no pose needed repair there) and logs the pose-repair
    skip; tests/test_torch_parallel.py runs two ranks against JAX's mesh."""
    import json

    import torch.distributed as dist

    from multicam_calibration_tpu_torch.parallel import make_frame_mesh
    from multicam_calibration_tpu_torch.utils.metrics import metrics

    plain = tba.bundle_adjust(*problem[1], verbose=False, device=CPU)
    assert "n_poses_repaired" not in plain[4]
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    metrics.configure(str(tmp_path / "metrics.jsonl"))
    try:
        got = tba.bundle_adjust(*problem[1], verbose=False, device=CPU,
                                mesh=make_frame_mesh(device=CPU))
    finally:
        metrics.configure(None)
        dist.destroy_process_group()
    for a, b in zip((got[0], got[2], got[3]), (plain[0], plain[2], plain[3])):
        np.testing.assert_array_equal(a, b)
    assert sorted(got[4]) == sorted(plain[4])
    for k in got[4]:
        np.testing.assert_array_equal(got[4][k], plain[4][k])
    with open(tmp_path / "metrics.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert {"event": "ba_pose_repair_skipped", "reason": "mesh"} in [
        {k: e[k] for k in ("event", "reason") if k in e} for e in events]


@pytest.mark.parametrize("entry", [
    "calibrate", "get_intrinsics", "get_intrinsics_batch", "estimate_pose",
    "estimate_pose_batch", "estimate_pairwise_camera_transform", "estimate_all_extrinsics",
    "consensus_calib_poses", "bundle_adjust", "select_ba_frames", "residuals",
])
def test_entry_points_default_to_the_card(problem, monkeypatch, entry):
    """device=None means the CUDA device: numpy input raises without one
    instead of landing on the CPU. The host-only spanning tree needs none."""
    rig, (uvs, ext, intr, objp, poses) = problem
    Ks, ds = [k for k, _ in intr], [d for _, d in intr]
    pose_c = np.stack([poses] * 4)
    calls = {
        "calibrate": lambda: tmct.calibrate(uvs, rig.img_sizes, objp, verbose=False),
        "get_intrinsics": lambda: tmct.get_intrinsics(uvs[0], objp, rig.img_sizes[0]),
        "get_intrinsics_batch": lambda: tmct.get_intrinsics_batch(uvs, objp, rig.img_sizes),
        "estimate_pose": lambda: tmct.estimate_pose(uvs[0], objp, Ks[0], ds[0]),
        "estimate_pose_batch": lambda: tmct.estimate_pose_batch(uvs, objp, Ks, ds),
        "estimate_pairwise_camera_transform":
            lambda: tmct.estimate_pairwise_camera_transform(poses, poses),
        "estimate_all_extrinsics": lambda: tmct.estimate_all_extrinsics(pose_c),
        "consensus_calib_poses": lambda: tmct.consensus_calib_poses(pose_c, ext),
        "bundle_adjust": lambda: tmct.bundle_adjust(uvs, ext, intr, objp, poses, verbose=False),
        "select_ba_frames": lambda: tmct.select_ba_frames(uvs, ext, intr, objp, poses,
                                                          verbose=False),
        "residuals": lambda: tmct.residuals(tba.serialize_params(ext, intr, poses), uvs, objp),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert ti.get_camera_spanning_tree(pose_c) == [(0, 1), (0, 2), (0, 3)]


def test_stage_timers_and_profile(problem, tmp_path):
    """utils.metrics: the JAX package's API with one span API (``span``,
    ``timer`` its alias, and ``count``) in place of ``profile``;
    bundle_adjust's stage spans run and a configured sink gets one JSON
    line per event."""
    import json

    from multicam_calibration_tpu.utils.metrics import Metrics as JaxMetrics
    from multicam_calibration_tpu_torch.utils.metrics import Metrics, metrics

    public = lambda cls: {k for k in vars(cls) if not k.startswith("_")}  # noqa: E731
    assert public(Metrics) == public(JaxMetrics) - {"profile"} | {"span", "count"}
    assert Metrics.timer is Metrics.span
    sink = tmp_path / "metrics.jsonl"
    metrics.stage_times.clear()
    metrics.configure(str(sink))
    try:
        tba.bundle_adjust(*problem[1], verbose=False, device=CPU, lm_options=RECIPE)
    finally:
        metrics.configure(None)
    assert {"ba.select_frames", "ba.lm_solve", "ba.f64_polish",
            "ba.pose_repair"} <= set(metrics.summary())
    events = [json.loads(ln)["event"] for ln in sink.read_text().splitlines()]
    assert "stage_time" in events and "ba_result" in events and "ba_lm_iter" in events
