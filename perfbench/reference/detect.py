"""Plain reference for chessboard detection: the renderer's ground truth.

Every frame of the detection cells is rendered by the frozen generator
(``perfbench/frozen/render.py``) from a board pose whose corners it
projects through the camera's lens in float64 numpy; that projection is the
answer a detector owes. A frame either shows a detectable board (its
corners, in the board's own order) or shows none. Imports nothing of the
program.
"""
from __future__ import annotations

import numpy as np


def judge(found, truth, board, wrong_px):
    """Numbers by which detections are judged.

    ``found``: per frame the detected corners (N, 2) or None; ``truth``
    (n, N, 2); ``board`` (n,) whether the frame shows a detectable board.
    ``false_found``: detections on frames without a board. ``missed_share``:
    share of board frames with no detection. ``wrong_share``: share of the
    board frames' detections whose corners lie more than ``wrong_px`` RMS
    from the truth (a wrong lattice order). ``corner_rms_px``: RMS corner
    error of the other detections. ``corner_scatter_px``: the median over
    those frames of the RMS corner error after the frame's mean error is
    taken off: how well the corners keep the board's shape, apart from a
    shift of the whole frame (the median, because a few steep views carry
    most of a sum)."""
    board = np.asarray(board, bool)
    hit = np.array([f is not None for f in found])
    err, scatter = np.full(len(found), np.nan), np.full(len(found), np.nan)
    for i in np.nonzero(hit & board)[0]:
        d = np.asarray(found[i], float) - truth[i]
        err[i] = np.sqrt((d ** 2).sum(-1).mean())
        scatter[i] = np.sqrt(((d - d.mean(0)) ** 2).sum(-1).mean())
    on_board = hit & board
    wrong = on_board & (err > wrong_px)
    right = on_board & ~wrong
    return {
        "false_found": float((hit & ~board).sum()),
        "missed_share": float((board & ~hit).sum() / max(board.sum(), 1)),
        "wrong_share": float(wrong.sum() / max(on_board.sum(), 1)),
        "corner_rms_px": float(np.sqrt(np.mean(err[right] ** 2))) if right.any() else np.inf,
        "corner_scatter_px": float(np.median(scatter[right])) if right.any() else np.inf,
    }
