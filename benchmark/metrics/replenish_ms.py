"""replenish_ms: the stills driver's re-seeding of dead lanes
(``SpeedEstimator._replenish``: Harris and ``corner_subpix`` on the still,
the plane backprojection), ms a burst: the mean over the window's bursts of
the summed spans ``replenish``."""

from benchmark.metrics import _spans


def read(run):
    return _spans.mean_total_ms(run, "replenish")
