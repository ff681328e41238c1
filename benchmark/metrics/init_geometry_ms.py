"""init_geometry_ms: the frame-0 plate pose and plane backprojection on the
host in f64, ms a clip: the mean over the window's clips of the span
``init.geometry``."""

from benchmark.metrics import _spans


def read(run):
    return _spans.mean_total_ms(run, "init.geometry")
