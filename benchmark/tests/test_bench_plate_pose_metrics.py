"""The plate pose's readers (``plate_pose_polish_ms``, ``plate_pose_score_ms``,
``plate_pose_candidates``) on hand-made records of the program's spans and
counters, a program without them (the BA re-anchor, or a program that
keeps only the whole ``reanchor.plate_pose`` span) giving no reading."""

from types import SimpleNamespace

import pytest

from benchmark.tests.test_bench_metrics import _metric

M = 1_000_000  # ns in a ms
NAMES = ("plate_pose_polish_ms", "plate_pose_score_ms", "plate_pose_candidates")


def _clip(polish_ms, score_ms, candidates):
    """A scan runner's record: the re-anchor at 100 ms holding the plate pose
    (its polish, then its scoring) and then the MSV solve."""
    pose_end = 100 + polish_ms + score_ms
    spans = [("run", None, 0, 1000 * M), ("init", 0, 0, 50 * M),
             ("reanchor", 0, 100 * M, (pose_end + 20) * M),
             ("reanchor.plate_pose", 2, 100 * M, pose_end * M),
             ("reanchor.plate_pose.polish", 3, 100 * M, (100 + polish_ms) * M),
             ("reanchor.plate_pose.score", 3, (100 + polish_ms) * M, pose_end * M),
             ("reanchor.msv", 2, pose_end * M, (pose_end + 20) * M)]
    return {"timings": {"spans": spans, "counts": {"reanchor.iterations": 4,
                                                   "plate_pose.candidates": candidates,
                                                   "msv.rejected": 0, "msv.capped": 0}},
            "pulls": []}


def _run(clips):
    return SimpleNamespace(clips=clips, pcfg=SimpleNamespace(msv_frame=5), trace=None)


def test_plate_pose_readers_on_hand_made_records():
    run = _run([_clip(30, 10, 3), _clip(36, 14, 4), _clip(24, 6, 2)])
    assert _metric("plate_pose_polish_ms").read(run) == pytest.approx(30.0)
    assert _metric("plate_pose_score_ms").read(run) == pytest.approx(10.0)
    assert _metric("plate_pose_candidates").read(run) == pytest.approx(3.0)


def test_a_clip_without_the_plate_pose_takes_no_part():
    """A clip recorded without the MSV's plate pose (no record at all) is
    left out of the mean, as ``plate_pose_ms`` leaves it."""
    run = _run([_clip(30, 10, 3), {"timings": {"wall_s": 1.0}, "pulls": []}, _clip(20, 20, 5)])
    assert _metric("plate_pose_polish_ms").read(run) == pytest.approx(25.0)
    assert _metric("plate_pose_score_ms").read(run) == pytest.approx(15.0)
    assert _metric("plate_pose_candidates").read(run) == pytest.approx(4.0)


@pytest.mark.parametrize("timings", [
    {"wall_s": 1.0},  # no record at all
    {"spans": [("run", None, 0, 10), ("reanchor", 0, 2, 5)],  # the BA re-anchor
     "counts": {"reanchor.iterations": 8}},
    {"spans": [("run", None, 0, 10), ("reanchor", 0, 2, 9),  # the MSV before its parts had spans
               ("reanchor.plate_pose", 1, 2, 6), ("reanchor.msv", 1, 6, 9)],
     "counts": {"reanchor.iterations": 3, "msv.rejected": 0, "msv.capped": 0}},
])
def test_plate_pose_readers_read_nothing_without_their_spans(timings):
    run = _run([{"timings": timings, "pulls": []}])
    for name in NAMES:
        assert _metric(name).read(run) is None, name
