"""Calibration-target models and the chessboard detector."""
from .board import generate_chessboard_objpoints
from .detector import (
    corner_response,
    detect_chessboard,
    detect_chessboard_batch,
    detect_chessboard_batches,
    extend_grid,
    find_corner_candidates,
    refine_corners_subpix,
    reorder_chessboard_corners,
)
from .video import process_video, run_calibration_detection, summarize_detections

__all__ = [
    "generate_chessboard_objpoints",
    "corner_response",
    "detect_chessboard",
    "detect_chessboard_batch",
    "detect_chessboard_batches",
    "extend_grid",
    "find_corner_candidates",
    "refine_corners_subpix",
    "reorder_chessboard_corners",
    "process_video",
    "run_calibration_detection",
    "summarize_detections",
]
