"""frame_wait_ms: a per-frame driver's wait for the card each frame: the
median, over the window's clips and their frames after the MSV frame, of
the span ``frame.wait`` (the host's read of the stage-2 count after the
step's replay)."""

import statistics

from benchmark.metrics import _spans


def read(run):
    v = [sum(_spans.ms(c) for c in children if c[0] == "frame.wait")
         for _f, children in _spans.frames_after_msv(run)]
    return statistics.median(v) if v else None
