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
]
