"""The port's CLI, version and device defaults, on the CPU.

- ``calibrate --device cpu`` on tests/test_torch_video.py's two-camera mp4
  rig writes a JSON equal (1e-12) to the port's own ``calibrate`` ->
  ``bundle_adjust`` -> ``save_calibration`` on the same cached detections,
  with the rig's relative camera geometry recovered as the JAX package's
  CLI test asks (tests/test_cli_config.py: rotation within 0.02 rad,
  translation within 8 mm, focal length within 5%).
- ``adjust`` (with a checkpoint and ``--uncertainty``), ``export``
  (json -> jarvis -> gimbal -> json, equal to 1e-12) and ``flatibrate``
  run; ``benchmark`` at 3 cameras x 60 frames prints the JAX package's keys
  (multicam_calibration_tpu/cli.py:260-268) with ``"platform": "cpu"``.
- The port's ``_version.get_version`` reads a git worktree (whose ``.git``
  is a file).
- Device defaults: ``process_video``, ``run_calibration_detection``,
  ``compute_residual_metric`` and the CLI run on the CUDA device unless
  asked for the CPU, and raise without one.
- The new modules import neither JAX nor the JAX package.
"""
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from multicam_calibration_tpu_torch import cli
from multicam_calibration_tpu_torch.detection import video as tvideo
from multicam_calibration_tpu_torch.utils.io import load_calibration
from tests.test_torch_video import make_video_rig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOARD_ARGS = ["--board", "5", "7", "--square-size", "12.5"]
JAX_BENCHMARK_KEYS = ["n_cameras", "n_frames", "wall_s", "n_iters", "iters_per_s",
                      "final_cost", "platform"]


@pytest.fixture(scope="module")
def video_rig(tmp_path_factory):
    return make_video_rig(str(tmp_path_factory.mktemp("videos")))


@pytest.fixture(scope="module")
def calibrated(video_rig, tmp_path_factory):
    """(the calibrate command's JSON, its output dir)."""
    out = str(tmp_path_factory.mktemp("cli") / "calib.json")
    assert cli.main(["calibrate", *video_rig["paths"], "--output", out, *BOARD_ARGS,
                     "--device", "cpu"]) == 0
    return out


def _rel(ext):
    from multicam_calibration_tpu_torch.synthetic import _T_to_t6, _t6_to_T

    return _T_to_t6(_t6_to_T(ext[1]) @ np.linalg.inv(_t6_to_T(ext[0])))


def test_calibrate_command_equals_the_pipeline(video_rig, calibrated, tmp_path):
    import multicam_calibration_tpu_torch as tm

    uvs, img_sizes = tvideo.run_calibration_detection(
        video_rig["paths"], detection_options={"board_shape": (5, 7)}, device="cpu")
    objp = tm.generate_chessboard_objpoints((5, 7), 12.5)
    ext, intr, poses, _ = tm.calibrate(uvs, img_sizes, objp, n_samples_for_intrinsics=100,
                                       device="cpu")
    ext, intr, _, _, _ = tm.bundle_adjust(uvs, ext, intr, objp, poses, device="cpu")
    own = str(tmp_path / "own.json")
    tm.save_calibration(ext, intr, ["camA", "camB"], own)
    got, ref = json.load(open(calibrated)), json.load(open(own))
    assert list(got) == list(ref) == ["camA", "camB"]
    for name in ref:
        for key in ref[name]:
            np.testing.assert_allclose(got[name][key], ref[name][key], rtol=0, atol=1e-12)
    ext_est, intr_est, _ = load_calibration(calibrated, camera_names=["camA", "camB"])
    rel_est, rel_true = _rel(ext_est), _rel(video_rig["extrinsics"])
    np.testing.assert_allclose(rel_est[:3], rel_true[:3], atol=0.02)
    assert np.linalg.norm(rel_est[3:] - rel_true[3:]) < 8.0
    assert abs(intr_est[0][0][0, 0] - 900) / 900 < 0.05


def test_adjust_export_and_flatibrate_commands(video_rig, calibrated, tmp_path, capsys):
    import h5py

    out, ck = str(tmp_path / "adj.json"), str(tmp_path / "ba_state.npz")
    assert cli.main(["adjust", *video_rig["paths"], "--calibration", calibrated, "--output",
                     out, "--checkpoint", ck, "--uncertainty", *BOARD_ARGS,
                     "--device", "cpu"]) == 0
    assert os.path.exists(out) and dict(np.load(ck))["it_done"] >= 1
    assert "observation noise" in capsys.readouterr().out

    ext, intr, names = load_calibration(out)
    hops = [("json", out, str(tmp_path / "jarvis")), ("jarvis", str(tmp_path / "jarvis"),
                                                       str(tmp_path / "g")),
            ("gimbal", str(tmp_path / "g.h5"), str(tmp_path / "back"))]
    for (src_fmt, src, dst), dst_fmt in zip(hops, ("jarvis", "gimbal", "json")):
        assert cli.main(["export", src, dst, "--from-format", src_fmt,
                         "--to-format", dst_fmt]) == 0
    ext2, intr2, names2 = load_calibration(str(tmp_path / "back.json"))
    assert names2 == names
    np.testing.assert_allclose(np.asarray(ext2), np.asarray(ext), rtol=0, atol=1e-12)
    for (K2, d2), (K, d) in zip(intr2, intr):
        np.testing.assert_allclose(K2, K, rtol=0, atol=1e-12)
        np.testing.assert_allclose(d2, d, rtol=0, atol=1e-12)

    rng = np.random.default_rng(5)
    kp = rng.uniform(-300, 300, (200, 4, 3))
    kp[..., 2] = 0.1 * kp[..., 0] + 30 + rng.uniform(0, 80, (200, 4))
    with h5py.File(tmp_path / "kp.h5", "w") as h5:
        h5.create_dataset("keypoints", data=kp)
    npy = str(tmp_path / "flat.npy")
    assert cli.main(["flatibrate", str(tmp_path / "kp.h5"), "--output", npy, "--center",
                     "--device", "cpu"]) == 0
    assert np.load(npy).shape == (6,)


def test_benchmark_prints_the_jax_keys(capsys):
    assert cli.main(["benchmark", "--n-cameras", "3", "--n-frames", "60", "--max-iters", "20",
                     "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(rec) == JAX_BENCHMARK_KEYS
    assert rec["platform"] == "cpu" and rec["n_cameras"] == 3 and rec["n_iters"] >= 1
    assert np.isfinite(rec["final_cost"]) and rec["final_cost"] > 0


def test_version_reads_a_git_worktree(tmp_path):
    if shutil.which("git") is None:
        pytest.skip("git is not installed")
    env = dict(os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@e",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@e")
    main, wt = tmp_path / "main", tmp_path / "wt"
    main.mkdir()
    run = lambda *a, cwd=main: subprocess.run(["git", *a], cwd=cwd, env=env, check=True,  # noqa: E731
                                              capture_output=True, text=True).stdout
    run("init", "-q")
    (main / "README").write_text("x\n")
    run("add", "README")
    run("commit", "-q", "-m", "first")
    run("worktree", "add", "-q", str(wt))
    assert (wt / ".git").is_file()
    pkg = wt / "pkg"
    pkg.mkdir()
    shutil.copy(os.path.join(ROOT, "multicam_calibration_tpu_torch", "_version.py"), pkg)
    spec = importlib.util.spec_from_file_location("wt_version", pkg / "_version.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sha = run("rev-parse", "--short", "HEAD", cwd=wt).strip()
    assert mod.get_version().startswith(f"{mod._FALLBACK}+g{sha}")


def test_entry_points_default_to_the_card(video_rig, monkeypatch, tmp_path):
    from multicam_calibration_tpu_torch import viz

    paths = [shutil.copy(p, tmp_path) for p in video_rig["paths"]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rig_uvs = np.full((2, 3, 35, 2), 1.0)
    intr = [(np.eye(3), np.zeros(5))] * 2
    objp = np.zeros((35, 3))
    calls = [
        lambda: tvideo.process_video(paths[0]),
        lambda: tvideo.run_calibration_detection(paths),
        lambda: viz.compute_residual_metric(rig_uvs, np.zeros((2, 6)), intr, objp,
                                            np.zeros((3, 6))),
        lambda: cli.main(["detect", *paths]),
        lambda: cli.main(["calibrate", *paths]),
        lambda: cli.main(["benchmark", "--n-cameras", "2", "--n-frames", "10"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not any(os.path.exists(os.path.splitext(p)[0] + ".detections.h5") for p in paths)


def test_new_modules_import_without_jax():
    code = (
        "import sys\n"
        "import multicam_calibration_tpu_torch as m\n"
        "from multicam_calibration_tpu_torch import cli, viz, __version__\n"
        "from multicam_calibration_tpu_torch.detection import video, native_video\n"
        "from multicam_calibration_tpu_torch.utils import config, flops, io\n"
        "assert flops.device_peak_flops('NVIDIA H100 80GB HBM3') == (67e12, 34e12)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'multicam_calibration_tpu' not in sys.modules\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported at import time'\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
