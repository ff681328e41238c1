"""msv_capped: clips whose MSV LM stopped at its iteration cap
(``SolverConfig.max_iters_msv``) rather than converging: the sum over the
window's clips of the counter ``msv.capped``. A program that keeps no such
counter gives no reading."""

from benchmark.metrics import _spans


def read(run):
    v = [c["msv.capped"] for _s, c in _spans.records(run) if "msv.capped" in c]
    return sum(v) if v else None
