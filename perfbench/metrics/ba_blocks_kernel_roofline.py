"""Share of its roofline that the BA block build reaches, in %: the summed
least time of the ``ba_blocks_kernel`` launches over the summed device time
of ``ba_blocks_kernel`` and ``ba_reduce_kernel`` (one block build is one
launch of each).

Each launch counts the work its inputs need: the frozen ``ba_bounds`` at the
(cameras, frames, board points, observed points) of the problem the cell
solves. Every launch of the cell is at that problem (the mixed solve and
the pose repair build blocks over all selected frames); a launch whose
grid's second dimension is not the cell's camera count makes the metric
read nothing."""
from perfbench.frozen.bounds import ba_bounds


def read(ctx):
    shape = ctx["shapes"].get("ba_problem")
    if shape is None:
        return None
    C = shape[0]
    blocks = ctx["trace"].kernel_launches(lambda n: "ba_blocks_kernel" in n)
    reduce = ctx["trace"].kernel_launches(lambda n: "ba_reduce_kernel" in n)
    if not blocks or any(len(g) < 2 or g[1] != C for _, _, g in blocks):
        return None
    bound_s = len(blocks) * 1e-3 * ba_bounds(*shape)["ba_blocks_kernel"][0]
    return 100.0 * bound_s / sum(d for _, d, _ in blocks + reduce)
