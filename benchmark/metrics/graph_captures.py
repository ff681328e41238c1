"""graph_captures: captures of the frame step's CUDA graph in the window:
the sum over the window's clips of the counter ``graph.captures``. The
warm-up clip captures; a capture in the window means a graph was built
again."""

from benchmark.metrics import _spans


def read(run):
    recs = _spans.records(run)
    return sum(c.get("graph.captures", 0) for _s, c in recs) if recs else None
