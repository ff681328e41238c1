"""plate_pose_score_ms: the scoring of the frame-0 plate's candidate poses in
the MSV re-anchor (``pipeline/anchor.py:resolve_plate_pose``, host f64:
each candidate's per-frame ``solve_translation_np`` re-solves), ms a clip:
the mean over the window's clips of the span ``reanchor.plate_pose.score``.
A program that records no such span gives no reading."""

import statistics

from benchmark.metrics import _spans

SPAN = "reanchor.plate_pose.score"


def read(run):
    per_clip = [sum(_spans.ms(s) for s in spans if s[0] == SPAN)
                for spans, _c in _spans.records(run) if any(s[0] == SPAN for s in spans)]
    return statistics.fmean(per_clip) if per_clip else None
