"""Host time of an update's windowed LM solve, ms: the program's profiler
range ``rolling.lm_solve`` (the warm-started iterations through both BA
kernels, ending in one host read of the cameras) over the traced window,
divided by the updates in it."""


def read(ctx):
    ms = 1e3 * ctx["trace"].range_s("rolling.lm_solve")
    return ms / ctx["jobs"] if ms > 0 else None
