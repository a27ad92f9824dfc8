"""Each cell's control comes out not correct: at a tiny size on the CPU,
and at the cell's own size on the card."""
import pytest

from perfbench.tests.controls import control
from perfbench.tests.tiny import tiny

CELLS = ["rig6.detect_mixed", "stage64.rolling", "stage64.ba"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_cpu(cell):
    over = tiny(cell, frames_per_camera=16) if cell.startswith("rig6.detect") else tiny(cell)
    if cell.startswith("rig6.detect"):
        over["mix"].update(batch=16, board_per_batch=8)
    r = control(cell, 21, "cpu", seconds=0.5, overrides=over)
    assert r["correct"] is False, r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, cuda_device):
    for seed in (101, 102, 103):
        r = control(cell, seed, cuda_device)
        assert r["correct"] is False, r["checks"]
