"""Share of its roofline that the corner kernel reaches, in %: the summed
least time of its launches over their summed device time.

Every launch of ``corner_kernel<kPeaks, RG>`` in the traced window counts
its own work: its frames are the grid's third dimension, its frame size the
cell's, its Gaussian sigma the one its compile-time radius belongs to
(``RG`` 5, 11, 18, 27 for sigma 1.5, 3.5, 6, 9: stage 1 and the coarse
ladder, detector.py ``_COARSE_SCALES``), and the bound is the frozen
``corner_bound``. A launch of the run-time-radius instantiation (``RG`` 0)
has no sigma in its name; the metric reads nothing where one ran."""
import re

from perfbench.frozen.bounds import corner_bound

SIGMA = {5: 1.5, 11: 3.5, 18: 6.0, 27: 9.0}
NAME = re.compile(r"corner_kernel<\s*(true|false)\s*,\s*(\d+)\s*>")


def read(ctx):
    H, W = ctx["shapes"]["frame_hw"]
    nms = ctx["shapes"]["nms_radius"]
    bound_s = time_s = 0.0
    for name, dur, grid in ctx["trace"].kernel_launches(lambda n: "corner_kernel<" in n):
        m = NAME.search(name)
        if m is None or int(m.group(2)) not in SIGMA or len(grid) != 3:
            return None
        bound_s += 1e-3 * corner_bound(grid[2], H, W, SIGMA[int(m.group(2))], nms,
                                       m.group(1) == "true")[0]
        time_s += dur
    return 100.0 * bound_s / time_s if time_s > 0 else None
