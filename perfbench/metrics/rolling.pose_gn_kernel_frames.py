"""Camera-frames an update's pose polish hands to the card's
``pose_gn_kernel``: the program's counter ``estimate_pose.gn_kernel.frames``
over the traced window, divided by the updates in it (64 x 8 = 512 at
stage64.rolling; 0 where the polish ran its plain twin on the CPU).
Nothing where the program keeps no such counter."""


def read(ctx):
    n = ctx["stage_times"].get("estimate_pose.gn_kernel.frames")
    return n / ctx["jobs"] if n is not None else None
