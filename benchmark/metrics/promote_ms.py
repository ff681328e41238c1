"""promote_ms: the stills driver's promotion of re-seeded lanes into the
solve (``StillsSpeedEstimator._promote_pending``: N-ray triangulation on the
host), ms a burst: the mean over the window's bursts of the summed spans
``promote``."""

from benchmark.metrics import _spans


def read(run):
    return _spans.mean_total_ms(run, "promote")
