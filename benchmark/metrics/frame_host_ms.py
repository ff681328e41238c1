"""frame_host_ms: a per-frame driver's own host time each frame: the
median, over the window's clips and their frames after the MSV frame, of
the span ``frame`` less its ``frame.wait`` children (the upload, the
replay's launch, the host reads after the wait, replenishment and
promotion)."""

import statistics

from benchmark.metrics import _spans


def read(run):
    v = [_spans.ms(f) - sum(_spans.ms(c) for c in children if c[0] == "frame.wait")
         for f, children in _spans.frames_after_msv(run)]
    return statistics.median(v) if v else None
