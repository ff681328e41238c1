"""plate_pose_polish_ms: the candidate poses of the frame-0 plate in the MSV
re-anchor (``solvers/pose.py:plate_pose_candidates``, host f64: the
homography, its mirror and the seeded polishes), ms a clip: the mean over
the window's clips of the span ``reanchor.plate_pose.polish``. A program
that records no such span gives no reading."""

import statistics

from benchmark.metrics import _spans

SPAN = "reanchor.plate_pose.polish"


def read(run):
    per_clip = [sum(_spans.ms(s) for s in spans if s[0] == SPAN)
                for spans, _c in _spans.records(run) if any(s[0] == SPAN for s in spans)]
    return statistics.fmean(per_clip) if per_clip else None
