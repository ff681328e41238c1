"""frames_per_s: the frames (video frames or stills) of every clip completed
in the window, over the window (from the first clip's call to the last
clip's return)."""


def read(run):
    if not run.clips or run.window_s <= 0:
        return None
    return sum(c["frames"] for c in run.clips) / run.window_s
