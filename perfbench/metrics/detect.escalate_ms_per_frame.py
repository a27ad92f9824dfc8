"""Host time of the detector's occlusion escalation per frame: the
program's span ``detect.finish.escalate`` (a second host lattice search
with a relaxed hole budget, its refine-and-score pass and picks) over the
traced window, in ms, divided by the frames whose detections came back in
it."""


def read(ctx):
    ms = 1e3 * ctx["stage_times"].get("detect.finish.escalate", 0.0)
    return ms / ctx["units"] if ms > 0 and ctx["units"] else None
