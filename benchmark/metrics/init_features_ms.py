"""init_features_ms: the frame-0 features (Harris, ``corner_subpix`` and
their host reads, the first host read of a run, so the scan runner's upload
tail lands here), ms a clip: the mean over the window's clips of the span
``init.features``."""

from benchmark.metrics import _spans


def read(run):
    return _spans.mean_total_ms(run, "init.features")
