"""reanchor_iters: the re-anchor's solver iterations a clip (BA's or the
MSV's LM): the mean over the window's clips of the counter
``reanchor.iterations``. ``reanchor_ms`` over it is ms per iteration."""

import statistics

from benchmark.metrics import _spans


def read(run):
    v = [c.get("reanchor.iterations", 0) for _s, c in _spans.records(run)]
    return statistics.fmean(v) if v else None
