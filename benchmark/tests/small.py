"""A cell at a size a CPU test run can hold: the configuration's view at
480 pixels wide, a few frames, a small tracker, and the limits that this
size reads against (sound runs read at most a fifth of each; the control
several times each)."""

FEATURES, TRIALS, MSV = 128, 64, 3
WIDTH = 480
FRAMES = 8  # a clip at this size
LIMITS = {"track_err_px": 0.5, "residual_px": 0.8}


def shrink(width: int = WIDTH, pool: int = 1):
    """``adjust`` for ``harness.run_cell``: the same view at ``width``."""

    def adjust(config, traffic):
        sc = config["scene"]
        k = width / sc["width"]
        sc["width"], sc["height"] = width, int(round(sc["height"] * k))
        sc["focal_px"] *= k
        sc["principal_point"] = [sc["width"] / 2 + 0.5, sc["height"] / 2 + 0.5]
        pipe = config["pipeline"]
        pipe["msv_frame"] = MSV
        pipe["tracker"] = {"max_features": FEATURES, "ransac_trials": TRIALS}
        traffic["frames"] = FRAMES
        traffic["pool"] = pool

    return adjust
