"""plate_pose_ms: the frame-0 planar-pose disambiguation in the MSV
re-anchor (``pipeline/anchor.py:resolve_plate_pose``, host f64: each
candidate pose's per-frame translation solves), ms a clip: the mean over
the window's clips of the span ``reanchor.plate_pose``. A program that
records no such span gives no reading."""

import statistics

from benchmark.metrics import _spans


def read(run):
    per_clip = [sum(_spans.ms(s) for s in spans if s[0] == "reanchor.plate_pose")
                for spans, _c in _spans.records(run)
                if any(s[0] == "reanchor.plate_pose" for s in spans)]
    return statistics.fmean(per_clip) if per_clip else None
