"""clip_p95_s: the 95th percentile, over every clip completed in the window,
of the wall from the call into the driver to its return with the results
on the host (linear between the closest ranks)."""

from benchmark import stats


def read(run):
    walls = [c["wall_s"] for c in run.clips]
    return stats.percentile(walls, 95) if walls else None
