"""subpix_iters: the subpixel refinement's iterations a clip (frame-0 init
and each re-seeding): the mean over the window's clips of the counter
``subpix.iterations``, to which each refinement adds the most iterations
any of its points ran, the eager loop's trip count. A program that keeps
no such counter gives no reading."""

import statistics

from benchmark.metrics import _spans


def read(run):
    v = [c["subpix.iterations"] for _s, c in _spans.records(run) if "subpix.iterations" in c]
    return statistics.fmean(v) if v else None
