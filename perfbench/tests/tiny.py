"""Each cell cut to a size that a CPU test can run in seconds."""
TINY = {
    "rig6.detect_mixed": {"config": {"n_cameras": 2, "frames_per_camera": 8},
                          "mix": {"batch": 8, "board_per_batch": 3,
                                  "trajectory_frames": 300}},
    "stage64.rolling": {"config": {"n_cameras": 16,
                                   "rolling": {"window": 32, "iters_per_update": 3,
                                               "protect_recent": 8}},
                        "mix": {"fill_updates": 4, "max_updates_per_s": 10}},
    "stage64.ba": {"config": {"n_cameras": 8, "n_frames": 300,
                              "bundle_adjust": {"n_frames": 200}}},
}


def tiny(cell, **extra):
    """The cell's overrides, with ``extra`` merged into its config."""
    out = {k: dict(v) for k, v in TINY[cell].items()}
    for k, v in extra.items():
        if isinstance(v, dict):
            out["config"][k] = {**out["config"].get(k, {}), **v}
        else:
            out["config"][k] = v
    return out
