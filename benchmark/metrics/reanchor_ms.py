"""reanchor_ms: the re-anchor at the MSV frame (``pipeline/anchor.py:
reanchor``, BA or MSV on the host in f64), ms a clip: the mean over the
window's clips of the span ``reanchor``."""

from benchmark.metrics import _spans


def read(run):
    return _spans.mean_total_ms(run, "reanchor")
