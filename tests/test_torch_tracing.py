"""The port's one span API (``utils.metrics``), on the CPU.

- ``metrics.span`` adds its seconds and ``metrics.count`` its total to
  ``stage_times`` under the given name; under ``torch.profiler`` a span is
  a range of the same name, and nested spans nest.
- A span inside the vmapped ``_estimate_pose_impl`` is one range per slab,
  and ``_batched_estimate_pose`` returns the same bits with and without an
  active profiler.
- Coverage: the phase spans account for at least 90% of the span that
  holds them in the detector's host half, the rolling update's pose init
  and ``bundle_adjust``.
- The counters: ``detect.coarse.*`` on board-less frames and
  ``ba.pose_repair.flagged`` on a rig with known bad poses.
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu_torch.detection import synthetic_images as tsyn
from multicam_calibration_tpu_torch.models import bundle_adjustment as tba
from multicam_calibration_tpu_torch.models import initialize as tinit
from multicam_calibration_tpu_torch.models.lm_core import LMOptions
from multicam_calibration_tpu_torch.utils.metrics import Metrics, metrics

CPU = torch.device("cpu")
BOARD = (5, 7)
COVERAGE = 0.9
DETECT_PHASES = ("fast", "lattice", "hypotheses", "repair", "coarse", "escalate", "rescue")
BA_STAGES = ("ba.select_frames", "ba.prepare", "ba.lm_solve", "ba.f64_polish",
             "ba.pose_repair")


def _profiled(fn):
    """(fn's result, the profiler ranges of one CPU profiler session around
    it). The ranges come from the session's Chrome trace, as the
    benchmark's traced runs read them (``FunctionEvent`` lists of these
    vmapped solves take seconds to build)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _ranges(events, name):
    return [(s, t) for n, s, t in events if n == name]


def _coverage(events, parent, children):
    """Share of the ``parent`` ranges' time that ranges named in
    ``children`` inside them cover (the children do not nest in one
    another)."""
    outer = _ranges(events, parent)
    inner = [(s, t) for c in children for s, t in _ranges(events, c)
             if any(a <= s and t <= b for a, b in outer)]
    return sum(t - s for s, t in inner) / sum(t - s for s, t in outer)


def _delta(before):
    return {k: v - before.get(k, 0) for k, v in metrics.stage_times.items()}


def test_span_and_count_accumulate_and_nest(tmp_path):
    m = Metrics()
    sink = tmp_path / "metrics.jsonl"
    m.configure(str(sink))
    try:
        def body():
            with m.span("outer", batch=3):
                with m.span("inner"):
                    torch.ones(8).sum()
                with m.span("inner"):
                    pass
            m.count("things", 4)
            m.count("things")

        _, events = _profiled(body)
        with m.span("outer"):
            pass
    finally:
        m.configure(None)
    assert set(m.stage_times) == {"outer", "inner", "things"}
    assert m.stage_times["things"] == 5
    assert 0 < m.stage_times["inner"] <= m.stage_times["outer"]
    (outer,) = _ranges(events, "outer")
    inner = _ranges(events, "inner")
    assert len(inner) == 2 and all(outer[0] <= s and t <= outer[1] for s, t in inner)
    logged = [json.loads(ln) for ln in sink.read_text().splitlines()]
    assert [(r["event"], r["stage"]) for r in logged] == [
        ("stage_time", "inner"), ("stage_time", "inner"), ("stage_time", "outer"),
        ("stage_time", "outer")]
    assert logged[2]["batch"] == 3


@pytest.fixture(scope="module")
def pose_inputs():
    rig = tmct.make_synthetic_rig(3, 12, noise_px=0.3, dropout=0.2, seed=5)
    return (torch.as_tensor(rig.all_calib_uvs),
            torch.stack([torch.as_tensor(K) for K, _ in rig.all_intrinsics]),
            torch.stack([torch.as_tensor(d).reshape(-1) for _, d in rig.all_intrinsics]),
            torch.as_tensor(rig.calib_objpoints))


def test_pose_spans_inside_vmap_change_no_bits(pose_inputs, monkeypatch):
    monkeypatch.setattr(tinit, "POSE_BATCH", 3 * 8)  # two slabs of frames
    plain = tinit._batched_estimate_pose(*pose_inputs)
    before = dict(metrics.stage_times)
    traced, events = _profiled(lambda: tinit._batched_estimate_pose(*pose_inputs))
    assert np.array_equal(plain.numpy(), traced.numpy(), equal_nan=True)
    assert np.isfinite(plain.numpy()).all(-1).sum() > 0
    for name in ("estimate_pose.homography", "estimate_pose.gauss_newton"):
        assert len(_ranges(events, name)) == 2  # once per slab, not per camera
        assert _delta(before)[name] > 0


@pytest.fixture(scope="module")
def detect_run():
    """Two streamed batches: two board views with two board-less frames,
    then three board-less frames; the counters after each batch."""
    def view(seed, board):
        H = (tsyn.random_view_homography(np.random.default_rng(seed), board_shape=BOARD)
             if board else np.array([[1.0, 0, 5000], [0, 1, 5000], [0, 0, 1]]))
        v, _ = tsyn.render_board_view(H, out_size=(480, 640), board_shape=BOARD,
                                      noise=1.5, seed=seed)
        return v.astype(np.uint8)

    batches = [[view(3100, True), view(1, False), view(3101, True), view(2, False)],
               [view(3, False), view(4, False), view(5, False)]]

    def run():
        counts = [dict(metrics.stage_times)]
        outs = []
        for out in tmct.detect_chessboard_batches(batches, board_shape=BOARD, device=CPU):
            outs.append(out)
            counts.append(dict(metrics.stage_times))
        return outs, counts

    (outs, counts), events = _profiled(run)
    return outs, counts, events


def test_detector_phase_spans_cover_the_finish(detect_run):
    outs, _, events = detect_run
    assert sorted(outs[0]) == [0, 2] and outs[1] == {}
    assert len(_ranges(events, "detect_chessboard_batches.finish")) == 2
    assert _coverage(events, "detect_chessboard_batches.finish",
                     [f"detect.finish.{p}" for p in DETECT_PHASES]) >= COVERAGE


def test_coarse_counters_on_board_less_frames(detect_run):
    _, counts, _ = detect_run
    last = {k: counts[2].get(k, 0) - counts[1].get(k, 0)
            for k in ("detect.coarse.tried", "detect.coarse.accepted")}
    # Three board-less frames enter each of the three rungs; none is accepted.
    assert last == {"detect.coarse.tried": 9, "detect.coarse.accepted": 0}
    first = counts[1].get("detect.coarse.tried", 0) - counts[0].get("detect.coarse.tried", 0)
    assert first >= 6


def test_rolling_pose_spans_cover_the_pose_init():
    rig = tmct.make_synthetic_rig(16, 40, noise_px=0.3, dropout=0.15, seed=21)
    rng = np.random.default_rng(0)
    ext = rig.all_extrinsics.copy()
    ext[1:, :3] += rng.normal(0, 0.005, (15, 3))
    ext[1:, 3:] += rng.normal(0, 3.0, (15, 3))
    cal = tmct.RollingCalibrator(ext, rig.all_intrinsics, rig.calib_objpoints, window=24,
                                 iters_per_update=2, protect_recent=8, device=CPU)
    cal.update(rig.all_calib_uvs[:, :24])
    _, events = _profiled(lambda: cal.update(rig.all_calib_uvs[:, 24:32]))
    assert len(_ranges(events, "rolling.pose_init")) == 1
    assert _coverage(events, "rolling.pose_init",
                     ["estimate_pose.homography", "estimate_pose.gauss_newton",
                      "consensus_calib_poses"]) >= COVERAGE


def test_bundle_adjust_stage_spans_cover_the_call():
    rig = tmct.make_synthetic_rig(4, 80, noise_px=0.3, dropout=0.25, seed=7)
    ext = rig.all_extrinsics + np.random.default_rng(3).normal(0, 2e-3, (4, 6))
    recipe = dict(block_dtype="float32", cost_dtype="float32", solve_dtype="float32",
                  grad_dtype="float32", gtol_rel=1e-6, lambda_escalation=3.0)

    def call():
        with metrics.span("test.bundle_adjust"):
            return tba.bundle_adjust(rig.all_calib_uvs, ext, rig.all_intrinsics,
                                     rig.calib_objpoints, rig.calib_poses, verbose=False,
                                     device=CPU, lm_options=recipe)

    _, events = _profiled(call)
    for name in BA_STAGES + ("ba.select_frames.predict", "ba.select_frames.host",
                             "ba.pose_repair.flag"):
        assert _ranges(events, name), name
    assert _coverage(events, "test.bundle_adjust", BA_STAGES) >= COVERAGE


@pytest.mark.parametrize("n_bad", [0, 3])
def test_repair_counter_counts_the_flagged_frames(n_bad):
    """At the true rig every frame's error is noise; ``n_bad`` poses moved
    far off are the frames the repair flags."""
    rig = tmct.make_synthetic_rig(4, 60, noise_px=0.3, dropout=0.0, seed=9)
    f64 = dict(dtype=torch.float64, device=CPU)
    obs_np = rig.all_calib_uvs
    cam = torch.as_tensor(tba._params_to_arrays(rig.all_extrinsics, rig.all_intrinsics), **f64)
    poses = torch.as_tensor(rig.calib_poses, **f64).clone()
    poses[[5, 17, 40][:n_bad], 3:] += 300.0
    mask = torch.as_tensor(~np.isnan(obs_np).any(-1))
    obs = torch.as_tensor(np.nan_to_num(obs_np), **f64)
    before = dict(metrics.stage_times)
    tba._repair_bad_poses(cam, poses, obs, mask, torch.as_tensor(rig.calib_objpoints, **f64),
                          LMOptions(ftol=1e-4, loss="soft_l1", max_iters=20))
    delta = _delta(before)
    assert delta["ba.pose_repair.flagged"] == n_bad
    assert (delta.get("ba.pose_repair.reinit", 0) > 0) == (n_bad > 0)
