"""plate_pose_candidates: the candidate poses of the frame-0 plate that the
MSV re-anchor scores against the early tracks, a clip: the mean over the
window's clips of the counter ``plate_pose.candidates``. A program that
keeps no such counter gives no reading."""

import statistics

from benchmark.metrics import _spans


def read(run):
    v = [c["plate_pose.candidates"] for _s, c in _spans.records(run)
         if "plate_pose.candidates" in c]
    return statistics.fmean(v) if v else None
