"""multicam_calibration_tpu_torch — the PyTorch/CUDA port of multicam_calibration_tpu.

The same module layout and public names as the JAX package, written in
PyTorch for one NVIDIA GPU (Hopper, sm_90a), with the JAX package's Pallas
TPU kernels replaced by hand-written CUDA kernels (``csrc/``). It imports
neither JAX nor the JAX package. Ported so far: the calibration pipeline
(``models.initialize.calibrate`` -> ``models.bundle_adjustment.bundle_adjust``
over the Schur-LM engine ``models.lm_core``) with its geometry ops and
masked reductions, the synthetic rig, the stage metrics
(``utils.metrics``), and chessboard detection (``detection.detector``:
the batch path at full resolution and in the low band, streamed batches,
the single-frame ``scale_factor`` path, the native lattice growth), and
what a lab runs after bundle adjustment: triangulation
(``ops.triangulation``), flatibration, calibration uncertainty and rolling
re-calibration (``models.streaming.RollingCalibrator``), and the lab's
path from videos to a saved calibration: video decode and the detection
cache (``detection.video``, ``detection.native_video``), calibration I/O and
config (``utils.io``, ``utils.config``), the residual metric and QC plots
(``viz``), the FLOP model (``utils.flops``) and the CLI (``cli``, ``python
-m multicam_calibration_tpu_torch``); see ROADMAP.md for the rest.

Entry points take numpy input and run on the CUDA device unless the caller
passes ``device="cpu"`` (or CPU tensors).
"""

from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .detection import (
    corner_response,
    detect_chessboard,
    detect_chessboard_batch,
    detect_chessboard_batches,
    extend_grid,
    find_corner_candidates,
    generate_chessboard_objpoints,
    process_video,
    refine_corners_subpix,
    reorder_chessboard_corners,
    run_calibration_detection,
    summarize_detections,
)
from .models.initialize import (
    calibrate,
    consensus_calib_poses,
    estimate_all_extrinsics,
    estimate_pairwise_camera_transform,
    estimate_pose,
    estimate_pose_batch,
    get_camera_spanning_tree,
    get_intrinsics,
    get_intrinsics_batch,
)
from .models.bundle_adjustment import (
    bundle_adjust,
    bundle_adjustment_sparsity,
    deserialize_params,
    embed_calib_objpoints,
    predict_calib_uvs,
    residuals,
    select_ba_frames,
    serialize_params,
)
from .models.lm_core import LMOptions, lm_solve
from .models.flatibration import (
    center_arena,
    flatibrate,
    flip_z_axis,
    get_floor_points,
)
from .models.streaming import RollingCalibrator
from .models.uncertainty import calibration_uncertainty
from .synthetic import make_synthetic_rig
from .utils.io import load_calibration, save_calibration
from .viz import (
    compute_residual_metric,
    overlay_detections,
    pad_axis_limits,
    plot_chessboard_qc_data,
    plot_residuals,
    plot_shared_detections,
    set_axis_limits,
    visualize_flatibration,
)

__all__ = list(_ops_all) + [
    "calibrate",
    "consensus_calib_poses",
    "estimate_all_extrinsics",
    "estimate_pairwise_camera_transform",
    "estimate_pose",
    "estimate_pose_batch",
    "get_camera_spanning_tree",
    "get_intrinsics",
    "get_intrinsics_batch",
    "bundle_adjust",
    "bundle_adjustment_sparsity",
    "residuals",
    "select_ba_frames",
    "generate_chessboard_objpoints",
    "corner_response",
    "detect_chessboard",
    "detect_chessboard_batch",
    "detect_chessboard_batches",
    "find_corner_candidates",
    "refine_corners_subpix",
    "deserialize_params",
    "embed_calib_objpoints",
    "predict_calib_uvs",
    "serialize_params",
    "LMOptions",
    "lm_solve",
    "make_synthetic_rig",
    "RollingCalibrator",
    "calibration_uncertainty",
    "flatibrate",
    "flip_z_axis",
    "center_arena",
    "get_floor_points",
    "extend_grid",
    "reorder_chessboard_corners",
    "process_video",
    "run_calibration_detection",
    "summarize_detections",
    "load_calibration",
    "save_calibration",
    "compute_residual_metric",
    "overlay_detections",
    "pad_axis_limits",
    "plot_chessboard_qc_data",
    "plot_residuals",
    "plot_shared_detections",
    "set_axis_limits",
    "visualize_flatibration",
]

# Git-derived (a clone or a worktree), else the installed metadata.
from ._version import __version__  # noqa: E402
