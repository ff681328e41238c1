"""msv_rejected_steps: the MSV LM's trial steps refused by its cost test, a
clip: the mean over the window's clips of the counter ``msv.rejected``. A
program that keeps no such counter gives no reading."""

import statistics

from benchmark.metrics import _spans


def read(run):
    v = [c["msv.rejected"] for _s, c in _spans.records(run) if "msv.rejected" in c]
    return statistics.fmean(v) if v else None
