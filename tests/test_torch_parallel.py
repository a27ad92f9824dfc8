"""The port's ``parallel/`` vs the JAX package's, at 2 ranks.

Two gloo ranks are spawned once for the module (``WORKER``, a free port, as
tests/test_multiprocess.py does); they import only the port and write
``rank{r}.npz``. The parent runs the JAX package's sharded functions on a
2-device mesh cut from conftest's 8 virtual CPU devices, and the port's
single-process functions, on the same numpy inputs (from seeds), all in
f64 on the plain routes. Tolerances:

- ``sharded_lm_solve`` (tests/test_input_pipeline.py's 3-camera, 21-frame
  rig, seed 4, from a seeded 1e-3 perturbation; 21 frames split 11 + 10
  and a padded frame): cost trajectory rtol 2e-6 (``__graft_entry__.py``'s
  certificate), final poses atol 1e-8, against JAX's sharded solve and the
  port's single-process ``lm_solve``;
- ``bundle_adjust(mesh=...)`` (tests/test_torch_bundle_adjust.py's
  problem): the same frames and iteration count as JAX's on its mesh,
  final cost rtol 1e-6;
- ``sharded_triangulate`` (tests/test_input_pipeline.py's 203 points with
  missing views): rtol 1e-10, NaN where JAX's is NaN;
- the input pipeline (tests/test_multiprocess.py's stub detector): exact.

The ranks agree bit for bit: cameras, poses, info, every try's camera
step. Each rank starts with TF32 on and must see it off inside the port.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import multicam_calibration_tpu as jmct
from multicam_calibration_tpu.models import lm_core as jlm
from multicam_calibration_tpu.models.bundle_adjustment import _params_to_arrays
from multicam_calibration_tpu.parallel import input_pipeline as jip
from multicam_calibration_tpu.parallel import sharded as jsh
from multicam_calibration_tpu_torch.models import bundle_adjustment as tba
from multicam_calibration_tpu_torch.models import lm_core as tlm
from multicam_calibration_tpu_torch.parallel import (
    assign_videos_to_host,
    collectives,
    make_frame_mesh,
    shard_ba_inputs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
N_RANKS = 2
LM_ITERS = 5
TRAJ_RTOL, POSE_ATOL, COST_RTOL, TRI_RTOL = 2e-6, 1e-8, 1e-6, 1e-10
STUB = dict(n_cams=3, n_frames=5, n_pts=4)

WORKER = r"""
import os, sys
import numpy as np

rank, size, port, outdir, repo = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                  sys.argv[4], sys.argv[5])
sys.path.insert(0, repo)
import torch
import torch.distributed as dist

# A worker that forgets the port's numerics contract: TF32 on.
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True
torch.set_float32_matmul_precision("high")
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=size)

from multicam_calibration_tpu_torch.models import bundle_adjustment as tba, lm_core
from multicam_calibration_tpu_torch.parallel import (
    assign_videos_to_host, distributed_calibration_detection, gather_detections,
    make_frame_mesh, shard_ba_inputs, sharded_lm_solve, sharded_triangulate)
from multicam_calibration_tpu_torch.utils.metrics import metrics

inp = np.load(os.path.join(outdir, "inputs.npz"))
out = {}
precision, dcams = set(), []
solve = lm_core._equilibrated_solve


def recording_solve(M, b):
    precision.add(" ".join(map(str, (torch.backends.cuda.matmul.allow_tf32,
                                     torch.backends.cudnn.allow_tf32,
                                     torch.get_float32_matmul_precision()))))
    x = solve(M, b)
    dcams.append(x.numpy().copy())
    return x


lm_core._equilibrated_solve = recording_solve
mesh = make_frame_mesh(device="cpu")
lm_args = [torch.as_tensor(inp[k]) for k in ("lm_cam", "lm_poses", "lm_obs", "lm_mask",
                                             "lm_objp")]


def keep(label, cam, poses, info):
    out[label + "_cam"], out[label + "_poses"] = cam.numpy(), poses.numpy()
    out[label + "_history"] = info["history"].numpy()
    for k in ("n_iters", "nfev", "initial_cost", "final_cost", "lambda"):
        out[f"{label}_{k}"] = np.asarray(info[k])


for label, chunk, schedule in (("dense", None, "classic"), ("chunked", 4, "nielsen")):
    dcams.clear()
    opts = lm_core.LMOptions(max_iters=int(inp["lm_iters"]), frame_chunk=chunk,
                             damping_schedule=schedule)
    keep(label, *sharded_lm_solve(*lm_args, opts, mesh=mesh))
    out[label + "_dcam"] = np.stack(dcams)

o, m, p, F = shard_ba_inputs(inp["lm_obs"], inp["lm_mask"], inp["lm_poses"], mesh)
out["placed_shapes"] = np.array([o.to_local().shape[1], m.to_local().shape[1],
                                 p.to_local().shape[0], p.shape[0], F])
cam, poses, info = sharded_lm_solve(lm_args[0], p, o, m, lm_args[4],
                                    lm_core.LMOptions(max_iters=int(inp["lm_iters"])), mesh=mesh)
keep("placed", cam, poses[:F], info)

metrics.configure(os.path.join(outdir, f"metrics{rank}.jsonl"))
ba_args = (inp["ba_uvs"], inp["ba_ext"], list(zip(inp["ba_K"], inp["ba_dist"])),
           inp["ba_objp"], inp["ba_poses"])
ext, intr, poses, uf, info = tba.bundle_adjust(*ba_args, verbose=False, device="cpu",
                                               mesh=mesh)
out.update(ba_ext=ext, ba_K=np.stack([K for K, _ in intr]), ba_poses=poses, ba_uf=uf,
           ba_cost=info["final_cost"], ba_iters=info["n_iters"])
saves, savez = [], np.savez
tba.np.savez = lambda *a, **k: (saves.append(a[0]), savez(*a, **k))[1]
ck = os.path.join(outdir, "ba_mesh.npz")
tba.bundle_adjust(*ba_args, verbose=False, device="cpu", mesh=mesh, checkpoint_path=ck,
                  checkpoint_every=2, max_iters=2)
*_, uf, info = tba.bundle_adjust(*ba_args, verbose=False, device="cpu", mesh=mesh,
                                 checkpoint_path=ck, checkpoint_every=2, max_iters=4)
tba.np.savez = savez
out.update(ck_saves=len(saves), ck_uf=uf, ck_cost=info["final_cost"],
           ck_iters=info["n_iters"])
metrics.configure(None)

points = make_frame_mesh(axis_name="points", device="cpu")
tri = (list(inp["tri_uvs"]), list(inp["tri_ext"]), list(zip(inp["tri_K"], inp["tri_dist"])))
out["tri_median"] = sharded_triangulate(*tri, mesh=points, refine=False, device="cpu").numpy()
out["tri_refined"] = sharded_triangulate(*tri, mesh=points, device="cpu").numpy()
pts, sd = sharded_triangulate(*tri, mesh=points, return_sd=True, device="cpu")
out["tri_pts"], out["tri_sd"] = pts.numpy(), sd.numpy()

names = [f"cam{c}" for c in range(int(inp["gd_uvs"].shape[0]))]
_, mine = assign_videos_to_host(names)
out["gd_mine"] = np.array(mine)
out["gd"] = gather_detections(inp["gd_uvs"][mine], mine, *inp["gd_uvs"].shape[:3])


def stub_detect(frame, offset=0.0):
    # Corners encoding (camera, frame) through the pixels; camera 2 misses
    # frame 3 on purpose.
    cam, f = float(frame[0, 0]), float(frame[0, 1])
    if (cam, f) == (2.0, 3.0):
        return None
    base = np.arange(int(inp["stub_pts"]), dtype=float)
    return np.stack([base + 10 * cam + offset, base + f], axis=-1)


def frames(c, n):
    out = []
    for f in range(n):
        img = np.zeros((8, 8))
        img[0, 0], img[0, 1] = c, f
        out.append(img)
    return out


C, Fs = len(names), int(inp["stub_frames"])
paths = [os.path.join(outdir, f"cam{c}.avi") for c in range(C)]
aligned = np.stack([np.arange(Fs)] * C, axis=1).astype(float)
uvs, sizes = distributed_calibration_detection(
    paths, stub_detect, {"offset": 0.25}, aligned_frame_ixs=aligned,
    all_frames=[frames(c, Fs) for c in range(C)], device="cpu")
out["dcd_aligned"], out["dcd_sizes"] = uvs, np.asarray(sizes)
# Without alignment each rank counts its own frames: camera 1 has one less.
paths = [os.path.join(outdir, f"ragged{c}.avi") for c in range(C)]
uvs, _ = distributed_calibration_detection(
    paths, stub_detect, {"offset": 0.25},
    all_frames=[frames(c, Fs - (c == 1)) for c in range(C)], device="cpu")
out["dcd_ragged"] = uvs
try:  # more ranks than videos
    distributed_calibration_detection(paths[:1], stub_detect, device="cpu")
    out["dcd_refused"] = np.array("")
except ValueError as e:
    out["dcd_refused"] = np.array(str(e))

out["precision"] = np.array(sorted(precision))
np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
dist.destroy_process_group()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _lm_problem():
    """tests/test_input_pipeline.py's rig (3 x 21 frames, seed 4) from a
    seeded 1e-3 perturbation of the truth."""
    rig = jmct.make_synthetic_rig(n_cameras=3, n_frames=21, noise_px=0.3, dropout=0.1, seed=4)
    full = ~np.isnan(rig.all_calib_uvs).any((-1, -2))
    use = np.nonzero(full.sum(0) > 1)[0]
    rng = np.random.default_rng(5)
    cam = _params_to_arrays(rig.all_extrinsics, rig.all_intrinsics)
    cam = cam + rng.normal(0, 1e-3, cam.shape) * np.r_[[100.0] * 4, [1.0] * 8]
    obs = rig.all_calib_uvs[:, use]
    return dict(lm_cam=cam, lm_poses=rig.calib_poses[use] + rng.normal(0, 1e-3, (len(use), 6)),
                lm_obs=np.nan_to_num(obs), lm_mask=~np.isnan(obs).any(-1),
                lm_objp=rig.calib_objpoints, lm_iters=LM_ITERS)


def _ba_problem():
    """tests/test_torch_bundle_adjust.py's problem (4 cameras x 60 frames)."""
    rig = jmct.make_synthetic_rig(n_cameras=4, n_frames=60, noise_px=0.3, dropout=0.25, seed=7)
    rng = np.random.default_rng(3)
    ext = rig.all_extrinsics + rng.normal(0, 2e-3, rig.all_extrinsics.shape)
    Ks, dists = [], []
    for K, d in rig.all_intrinsics:
        fx, fy, cx, cy = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]) * (
            1 + rng.normal(0, 2e-3, 4))
        Ks.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]))
        dists.append(np.asarray(d))
    poses = rig.calib_poses + rng.normal(0, 2e-3, rig.calib_poses.shape)
    return dict(ba_uvs=rig.all_calib_uvs, ba_ext=ext, ba_K=np.stack(Ks), ba_dist=np.stack(dists),
                ba_objp=rig.calib_objpoints, ba_poses=poses)


def _tri_problem():
    """tests/test_input_pipeline.py's 203 points, with missing views."""
    rng = np.random.default_rng(3)
    rig = jmct.make_synthetic_rig(n_cameras=4, n_frames=10, noise_px=0.0, dropout=0.0, seed=3)
    pts = rng.standard_normal((203, 3)) * 30 + rig.calib_poses[:, 3:].mean(0)
    uvs = np.stack([
        np.asarray(jmct.project_points(pts, rig.all_extrinsics[c], *rig.all_intrinsics[c]))
        + rng.standard_normal((203, 2)) * 0.3 for c in range(4)])
    uvs[1][:5] = np.nan
    uvs[2][3:6] = np.nan
    uvs[:3, 200] = np.nan  # one view left: NaN
    return dict(tri_uvs=uvs, tri_ext=rig.all_extrinsics,
                tri_K=np.stack([K for K, _ in rig.all_intrinsics]),
                tri_dist=np.stack([d for _, d in rig.all_intrinsics]))


def _gd_problem():
    rng = np.random.default_rng(9)
    uvs = rng.random((3, 5, 4, 2))
    uvs[1, 2] = np.nan  # a slot no rank fills stays NaN
    return dict(gd_uvs=uvs, stub_frames=STUB["n_frames"], stub_pts=STUB["n_pts"])


class _Ranks:
    """The spawned ranks; ``load(rank)`` waits for all of them once."""

    def __init__(self, procs, outdir, inputs):
        self.procs, self.outdir, self.inputs, self._out = procs, outdir, inputs, None

    def load(self, rank):
        if self._out is None:
            logs = [p.communicate(timeout=240)[0].decode(errors="replace") for p in self.procs]
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, f"rank failed:\n{log}"
            self._out = [dict(np.load(self.outdir / f"rank{r}.npz")) for r in range(N_RANKS)]
        return self._out[rank]

    def metrics(self, rank):
        with open(self.outdir / f"metrics{rank}.jsonl") as f:
            return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("ranks")
    inputs = {**_lm_problem(), **_ba_problem(), **_tri_problem(), **_gd_problem()}
    np.savez(outdir / "inputs.npz", **inputs)
    script = outdir / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(r), str(N_RANKS), str(port), str(outdir), REPO],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(N_RANKS)
    ]
    yield _Ranks(procs, outdir, inputs)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_mesh():
    return jax.sharding.Mesh(np.array(jax.devices("cpu")[:N_RANKS]), ("frames",))


def _same_on_every_rank(ranks, keys):
    r0 = ranks.load(0)
    for r in range(1, N_RANKS):
        rr = ranks.load(r)
        for k in keys:
            assert np.array_equal(rr[k], r0[k], equal_nan=True), f"rank {r} differs in {k}"


@pytest.mark.parametrize("label,chunk,schedule", [("dense", None, "classic"),
                                                   ("chunked", 4, "nielsen")])
def test_sharded_lm_solve_matches_jax_and_one_process(ranks, jax_mesh, label, chunk, schedule):
    """The dense layout, and the chunked one with the gain ratio's
    all-reduces (the nielsen schedule)."""
    inp = ranks.inputs
    args = [inp[k] for k in ("lm_cam", "lm_poses", "lm_obs", "lm_mask", "lm_objp")]
    kw = dict(max_iters=LM_ITERS, frame_chunk=chunk, damping_schedule=schedule)
    cam_j, poses_j, info_j = jsh.sharded_lm_solve(
        *(jnp.asarray(a) for a in args), jlm.LMOptions(**kw), mesh=jax_mesh)
    cam_s, poses_s, info_s = tlm.lm_solve(*(torch.as_tensor(a) for a in args),
                                          tlm.LMOptions(**kw))
    got = ranks.load(0)
    n = int(got[f"{label}_n_iters"])
    assert n == int(info_j["n_iters"]) == info_s["n_iters"] >= 2
    assert int(got[f"{label}_nfev"]) == int(info_j["nfev"]) == info_s["nfev"]
    for ref in (np.asarray(info_j["history"]), info_s["history"].numpy()):
        np.testing.assert_allclose(got[f"{label}_history"][:n, 0], ref[:n, 0], rtol=TRAJ_RTOL)
    for ref in (np.asarray(poses_j), poses_s.numpy()):
        np.testing.assert_allclose(got[f"{label}_poses"], ref, rtol=0, atol=POSE_ATOL)
    assert got[f"{label}_poses"].shape == (args[1].shape[0], 6)
    assert float(got[f"{label}_final_cost"]) < float(got[f"{label}_initial_cost"])
    _same_on_every_rank(ranks, [f"{label}_{k}" for k in (
        "cam", "poses", "history", "n_iters", "nfev", "final_cost", "lambda", "dcam")])


def test_shard_ba_inputs_output_solves_as_global_arrays(ranks):
    """shard_ba_inputs pads 21 frames to 22 and gives each rank its 11 as a
    DTensor; sharded_lm_solve takes them without re-slicing and solves as
    from the global arrays."""
    got = ranks.load(0)
    assert got["placed_shapes"].tolist() == [11, 11, 11, 22, 21]
    for k in ("cam", "poses", "history", "n_iters", "nfev"):
        np.testing.assert_array_equal(got[f"placed_{k}"], got[f"dense_{k}"])


def test_bundle_adjust_on_a_mesh_matches_jax(ranks, jax_mesh):
    inp = ranks.inputs
    args = (inp["ba_uvs"], inp["ba_ext"], list(zip(inp["ba_K"], inp["ba_dist"])),
            inp["ba_objp"], inp["ba_poses"])
    ref = jmct.bundle_adjust(*args, verbose=False, mesh=jax_mesh)
    got = ranks.load(0)
    np.testing.assert_array_equal(got["ba_uf"], ref[3])
    assert int(got["ba_iters"]) == int(ref[4]["n_iters"])
    np.testing.assert_allclose(float(got["ba_cost"]), float(ref[4]["final_cost"]), rtol=COST_RTOL)
    for r in range(N_RANKS):
        skips = [e for e in ranks.metrics(r) if e["event"] == "ba_pose_repair_skipped"]
        assert skips and all(e["reason"] == "mesh" for e in skips)
    _same_on_every_rank(ranks, ["ba_ext", "ba_K", "ba_poses", "ba_uf", "ba_cost", "ba_iters"])


def test_bundle_adjust_on_a_mesh_resumes_its_checkpoint(ranks, tmp_path):
    """A mesh run cut at 2 iterations, then resumed to 4: only rank 0 wrote
    (one file per 2-iteration chunk), and the result is the single-process
    port's for the same two calls."""
    inp = ranks.inputs
    args = (inp["ba_uvs"], inp["ba_ext"], list(zip(inp["ba_K"], inp["ba_dist"])),
            inp["ba_objp"], inp["ba_poses"])
    path = str(tmp_path / "ba.npz")
    kw = dict(verbose=False, device=CPU, checkpoint_path=path, checkpoint_every=2)
    tba.bundle_adjust(*args, max_iters=2, **kw)
    _, _, _, uf, info = tba.bundle_adjust(*args, max_iters=4, **kw)
    assert [int(ranks.load(r)["ck_saves"]) for r in range(N_RANKS)] == [2, 0]
    got = ranks.load(0)
    np.testing.assert_array_equal(got["ck_uf"], uf)
    assert int(got["ck_iters"]) == int(info["n_iters"]) == 4
    np.testing.assert_allclose(float(got["ck_cost"]), float(info["final_cost"]), rtol=COST_RTOL)
    _same_on_every_rank(ranks, ["ck_uf", "ck_cost", "ck_iters"])


def test_sharded_triangulate_matches_jax(ranks):
    inp = ranks.inputs
    args = (list(inp["tri_uvs"]), list(inp["tri_ext"]), list(zip(inp["tri_K"], inp["tri_dist"])))
    mesh = jax.sharding.Mesh(np.array(jax.devices("cpu")[:N_RANKS]), ("points",))
    got = ranks.load(0)
    ref_pts, ref_sd = jsh.sharded_triangulate(*args, mesh=mesh, return_sd=True)
    pairs = [(got["tri_median"], jsh.sharded_triangulate(*args, mesh=mesh, refine=False)),
             (got["tri_refined"], jsh.sharded_triangulate(*args, mesh=mesh)),
             (got["tri_pts"], ref_pts), (got["tri_sd"], ref_sd)]
    for port, ref in pairs:
        ref = np.asarray(ref)
        assert port.shape == ref.shape == (203, 3)
        np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
        np.testing.assert_allclose(port, ref, rtol=TRI_RTOL, atol=TRI_RTOL)
    assert np.isnan(got["tri_median"][200]).all()
    _same_on_every_rank(ranks, ["tri_median", "tri_refined", "tri_pts", "tri_sd"])


def test_gather_detections_restores_coverage(ranks):
    """Each rank holds its round-robin cameras; the two all-reduces give
    every rank the global array, NaN where no rank detected."""
    uvs = ranks.inputs["gd_uvs"]
    assert [ranks.load(r)["gd_mine"].tolist() for r in range(N_RANKS)] == [[0, 2], [1]]
    np.testing.assert_array_equal(ranks.load(0)["gd"], uvs)
    assert np.isnan(ranks.load(0)["gd"][1, 2]).all()
    _same_on_every_rank(ranks, ["gd"])


def test_distributed_calibration_detection_two_ranks(ranks):
    """The stub corners encode (camera, frame): each rank's cameras land at
    their global slots (the camera-kwarg slicing), a missed detection stays
    NaN, without alignment the ranks agree on the fewest frames, and more
    ranks than videos are refused."""
    got = ranks.load(0)
    uvs = got["dcd_aligned"]
    assert uvs.shape == (STUB["n_cams"], STUB["n_frames"], STUB["n_pts"], 2)
    base = np.arange(STUB["n_pts"], dtype=float)
    for c in range(STUB["n_cams"]):
        for f in range(STUB["n_frames"]):
            if (c, f) == (2, 3):
                assert np.isnan(uvs[c, f]).all()
                continue
            np.testing.assert_array_equal(uvs[c, f, :, 0], base + 10 * c + 0.25)
            np.testing.assert_array_equal(uvs[c, f, :, 1], base + f)
    assert got["dcd_sizes"].tolist() == [[8, 8]] * STUB["n_cams"]
    assert got["dcd_ragged"].shape[1] == STUB["n_frames"] - 1
    np.testing.assert_array_equal(got["dcd_ragged"], uvs[:, : STUB["n_frames"] - 1])
    assert "2 processes for 1 videos" in str(got["dcd_refused"])
    _same_on_every_rank(ranks, ["dcd_aligned", "dcd_sizes", "dcd_ragged"])


def test_ranks_keep_tf32_off(ranks):
    """Each rank turned TF32 on before any call; inside the port's solves
    it is off and f32 matmuls run at "highest"."""
    for r in range(N_RANKS):
        assert ranks.load(r)["precision"].tolist() == ["False False highest"]


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_assign_videos_to_host_matches_jax(world_of_one):
    paths = [f"cam{i}.mp4" for i in range(7)]
    assert assign_videos_to_host(paths) == (paths, list(range(7)))
    for host in range(3):
        assert assign_videos_to_host(paths, host, 3) == jip.assign_videos_to_host(paths, host, 3)


def test_shard_ba_inputs_at_world_size_one(world_of_one):
    """One rank holds every frame; nothing is padded; the DTensors are the
    inputs on the mesh's device."""
    inp = _lm_problem()
    mesh = make_frame_mesh(device=CPU)
    obs, mask, poses, F = shard_ba_inputs(inp["lm_obs"], inp["lm_mask"], inp["lm_poses"], mesh)
    assert F == inp["lm_poses"].shape[0] == poses.shape[0]
    np.testing.assert_array_equal(obs.to_local().numpy(), inp["lm_obs"])
    np.testing.assert_array_equal(mask.to_local().numpy(), inp["lm_mask"])
    assert obs.placements[0].dim == 1 and poses.placements[0].dim == 0
    assert obs.to_local().device.type == CPU


def test_make_frame_mesh_sets_up_a_group_of_one():
    """Without a group or a launcher's environment make_frame_mesh sets up a
    gloo group of one on the CPU; an all-reduce over it is the identity."""
    assert not dist.is_initialized()
    try:
        mesh = make_frame_mesh(axis_name="frames", device=CPU)
        assert mesh.mesh_dim_names == ("frames",) and mesh.size() == 1
        assert dist.get_backend() == "gloo" and mesh.device_type == CPU
        x = torch.arange(6.0).reshape(2, 3)
        np.testing.assert_array_equal(collectives.all_reduce(x, mesh).numpy(), x.numpy())
        with pytest.raises(ValueError, match="n_devices"):
            make_frame_mesh(n_devices=2, device=CPU)
    finally:
        dist.destroy_process_group()
