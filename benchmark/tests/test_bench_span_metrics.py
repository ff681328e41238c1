"""The readers of the program's spans and counters (``timings["spans"]``,
``timings["counts"]``, ``velocity_tpu_torch/utils/profiling.py``) on a
fixed synthetic run, and ``idle_unspanned_pct`` on a hand-made trace and
spans; a program that records no spans gives no reading."""

from types import SimpleNamespace

import pytest

from benchmark.tests.test_bench_metrics import _metric, _trace


def _record(msv_waits, msv=2):
    """A per-frame driver's spans in ms (1 ms = 1e6 ns): init 0-10 with its
    features 1-6 and geometry 6-9, then frames of 10 ms from 10 ms on, each
    a wait of the given ms at its end; the re-anchor in the MSV frame, a
    re-seeding in each frame from it on and a promotion after it."""
    M = 1_000_000
    spans = [("run", None, 0, 1000 * M), ("init", 0, 0, 10 * M), ("init.features", 1, 1 * M, 6 * M),
             ("init.geometry", 1, 6 * M, 9 * M)]
    for k, wait in enumerate(msv_waits, start=1):
        f0 = 10 * k * M
        j = len(spans)
        spans.append(("frame", 0, f0, f0 + 10 * M))
        spans.append(("frame.wait", j, f0 + (10 - wait) * M, f0 + 10 * M))
        if k == msv:
            spans.append(("reanchor", j, f0 + 1 * M, f0 + 3 * M))
        if k >= msv:
            spans.append(("replenish", j, f0 + 3 * M, f0 + 4 * M))
        if k > msv:
            spans.append(("promote", j, f0 + 4 * M, f0 + 4 * M + M // 2))
    return spans


def _span_run(clips, msv=2):
    return SimpleNamespace(clips=[{"timings": t, "pulls": []} for t in clips],
                           pcfg=SimpleNamespace(msv_frame=msv), trace=None)


def test_span_readers_on_a_fixed_run():
    a = {"spans": _record([1, 2, 3, 4, 5, 6]), "counts": {"reanchor.iterations": 4}}
    b = {"spans": _record([1, 1, 7, 8, 9, 9]),
         "counts": {"reanchor.iterations": 6, "graph.captures": 1}}
    run = _span_run([a, b])
    assert _metric("init_features_ms").read(run) == pytest.approx(5.0)
    assert _metric("init_geometry_ms").read(run) == pytest.approx(3.0)
    assert _metric("reanchor_ms").read(run) == pytest.approx(2.0)
    assert _metric("reanchor_iters").read(run) == pytest.approx(5.0)
    # frames after the MSV frame (2): waits 3, 4, 5, 6 and 7, 8, 9, 9
    assert _metric("frame_wait_ms").read(run) == pytest.approx(6.5)
    assert _metric("frame_host_ms").read(run) == pytest.approx(3.5)
    # re-seeding in frames 2..6 (5 ms a clip), promotion in 3..6 (2 ms)
    assert _metric("replenish_ms").read(run) == pytest.approx(5.0)
    assert _metric("promote_ms").read(run) == pytest.approx(2.0)
    assert _metric("graph_captures").read(run) == 1
    assert _metric("graph_captures").read(_span_run([a])) == 0


def test_span_readers_read_nothing_without_spans():
    """A program that records no spans (the parent of the change that
    added them) gives no reading, and no reader raises."""
    run = _span_run([{"wall_s": 1.0, "fps": 20.0}])
    run.trace = _trace([("k", 0, 10, 1)])
    for name in ("init_features_ms", "init_geometry_ms", "reanchor_ms", "reanchor_iters",
                 "frame_wait_ms", "frame_host_ms", "replenish_ms", "promote_ms",
                 "graph_captures"):
        assert _metric(name).read(run) is None, name


def test_idle_unspanned_pct_on_a_hand_made_trace(monkeypatch):
    """The traced clip's run is the recent run whose ``run`` span overlaps
    the trace's device activity; its idle time outside every child span, as
    a share of its idle time."""
    from velocity_tpu_torch.utils import profiling

    idle = _metric("idle_unspanned_pct")
    # run 100-200: a child 100-150 with a child 120-130, a child 160-190;
    # the card busy 110-125 and 140-165: idle 100-110, 125-140, 165-200
    traced = [("run", None, 100, 200), ("init", 0, 100, 150), ("init.features", 1, 120, 130),
              ("frame", 0, 160, 190)]
    other = [("run", None, 300, 400), ("frame", 0, 300, 400)]
    recent = [{"run": 7, "spans": traced, "counts": {}}, {"run": 8, "spans": other, "counts": {}}]
    monkeypatch.setattr(profiling, "recent_runs", lambda: recent)
    run = SimpleNamespace(trace=_trace([("k", 110, 125, 1), ("k", 140, 165, 2)]))
    # idle 60 ns inside the run; outside the children the card is busy
    # 150-160 and idle 190-200
    assert idle.read(run) == pytest.approx(100.0 * 10 / 60)
    # innermost: init 100-110 and 130-140 (20), init.features 125-130 (5),
    # frame 165-190 (25), the run itself 10
    assert idle.by_span(run) == pytest.approx(
        {"frame": 25e-6, "init": 20e-6, "run": 10e-6, "init.features": 5e-6})
    assert list(idle.by_span(run))[0] == "frame"
    # no recent run overlaps the trace, or the program keeps none
    run.trace = _trace([("k", 1000, 1100, 1)])
    assert idle.read(run) is None
    monkeypatch.delattr(profiling, "recent_runs")
    assert idle.read(run) is None and idle.by_span(run) is None
    assert idle.read(SimpleNamespace(trace=None)) is None
