"""Traffic is made from the seed alone: the same seed gives the same
inputs, another seed other inputs with the same make-up."""
import numpy as np
import pytest

from perfbench.harness import spec
from perfbench.harness.core import sub_seed
from perfbench.tests.tiny import tiny


def _job(cell, seed):
    c = spec.load_cell(cell)
    over = tiny(cell)
    c.config.update(over["config"])
    c.mix.update(over.get("mix", {}))
    return spec.job_module(c.mix["job"]).Job(c.config, c.mix, seed, "cpu", seconds=1)


def _inputs(job):
    if hasattr(job, "frames"):
        return [job.frames, job.truth]
    return [job.rig.all_calib_uvs, job.start[0]]


@pytest.mark.parametrize("cell", ["rig6.detect_mixed", "stage64.rolling", "stage64.ba"])
def test_same_seed_same_inputs_other_seed_other_inputs(cell):
    big = (1 << 31) + 12345
    a, b, c = _job(cell, big), _job(cell, big), _job(cell, big + 1)
    for x, y in zip(_inputs(a), _inputs(b)):
        np.testing.assert_array_equal(x, y)
    assert not all(np.array_equal(x, y, equal_nan=True) for x, y in zip(_inputs(a), _inputs(c)))
    if cell == "rig6.detect_mixed":  # the seed moves the views, not the mix
        B, nb = a.B, 3
        for j in (a, c):
            assert (j.board.reshape(-1, B).sum(1) == nb).all()
    if cell == "stage64.rolling":  # the same number of batches of the same size
        assert a.rig.all_calib_uvs.shape == c.rig.all_calib_uvs.shape


def test_sub_seeds_differ_and_take_large_seeds():
    assert sub_seed(1 << 40, 1) != sub_seed(1 << 40, 2) != sub_seed((1 << 40) + 1, 2)
    assert 0 <= sub_seed(2**31 + 7, 3) < 2**63
