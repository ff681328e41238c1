"""The drivers' spans and counters (``utils/profiling.py``).

- the recorder: nested spans with their parents, counters, the bounded
  list of recent runs, a run inside another recording into the outer one;
- a span is a ``record_function`` of its name only while a profiler
  records, and then its ``time.time_ns()`` start lies within 1 ms of its
  profiler event's;
- the three drivers' spans on the small clip and its stills burst: each
  span of the table under its parent and inside it, one ``frame`` (the
  per-frame drivers) or ``step`` (the scan runner) a frame, the re-anchor's
  iterations counted, no graph captured on the CPU; the scan runner's
  ``decode_s``, ``init_s`` and ``msv_s`` keep their meanings; a clip that
  the scan runner hands to the per-frame driver is one run;
- on a card (``python -m pytest --noconftest -m cuda
  tests/test_torch_spans.py``): a span around a kernel and a synchronise
  contains the kernel's device interval, read as ``benchmark/trace.py``
  reads a trace, and a second scan run at the same shapes captures no
  graph.

The clip and stills burst of ``tests/_torch_clip.py`` (480x270, 8
frames, msv_frame 3, f32 solver; that module imports JAX), run over their
first frames with 64 features and 32 RANSAC trials to keep the CPU's eager
steps short, and with the cells' BA re-anchor.
"""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner
from velocity_tpu_torch.pipeline.speedest import SpeedEstimator
from velocity_tpu_torch.pipeline.stills import StillsSpeedEstimator
from velocity_tpu_torch.testing.synthetic_clip import SyntheticStillsReader, render_clip
from velocity_tpu_torch.utils import profiling
from velocity_tpu_torch.utils.profiling import StageTimer

torch.set_num_threads(1)

N_FRAMES, WIDTH, HEIGHT, MSV = 8, 480, 270, 3
RUN = MSV + 2  # frames a run takes: the MSV frame and the one after it
BURST = dict(speed_kmh=40.0, depth0_m=4.0, stride=3, filename="synthetic.JPG", native_scale=1.0)
ALWAYS = 10**6  # min_affine_inliers that sends every frame through the rescue


def _cfg(**tracker):
    return PipelineConfig(solver=SolverConfig(dtype="float32"), msv_frame=MSV, anchor="ba",
                          tracker=TrackerConfig(max_features=64, ransac_trials=32, **tracker))


@pytest.fixture(scope="module")
def clip():
    return render_clip(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, seed=0)


@pytest.fixture(scope="module")
def burst():
    return render_clip(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, seed=0, **BURST)


def _first_stills(burst, k):
    full = burst.stills()
    return SyntheticStillsReader(full.grays[:k], full.info, full.fps)


def _names(spans):
    return [s[0] for s in spans]


def _children(spans, name):
    """{parent name: count} of the spans of ``name``."""
    out = {}
    for s in spans:
        if s[0] == name:
            parent = spans[s[1]][0] if s[1] is not None else None
            out[parent] = out.get(parent, 0) + 1
    return out


def _well_nested(spans):
    """One root ``run``, every span closed and inside its parent."""
    assert [s for s in spans if s[1] is None] == [spans[0]] and spans[0][0] == "run"
    for name, parent, start, end in spans:
        assert start <= end, name
        if parent is not None:
            p = spans[parent]
            assert p[2] <= start and end <= p[3], (name, p[0])


def _one_record(fn):
    """(the result of ``fn()``, the one record it added to recent_runs())."""
    before = [r["run"] for r in profiling.recent_runs()]
    res = fn()
    added = [r for r in profiling.recent_runs() if r["run"] not in before]
    assert len(added) == 1
    assert res.timings["spans"] == added[0]["spans"]
    assert res.timings["counts"] == added[0]["counts"]
    return res, added[0]


class _Driver:
    """A stand-in driver whose run opens the spans it is given."""

    @profiling.recorded
    def run(self, names, inner=None):
        for name in names:
            with profiling.span(name):
                profiling.count("calls")
                if inner is not None:
                    inner.run(["inner"])
        return SimpleNamespace(timings={"wall_s": 0.0})


def test_recorder_nests_spans_and_counts():
    t = StageTimer()
    with t.stage("a"):
        with t.stage("b"):
            t.count("n", 2)
        with t.stage("c"):
            pass
        t.count("n")
    with t.stage("a"):
        pass
    assert [(name, parent) for name, parent, _s, _e in t.spans] == [
        ("a", None), ("b", 0), ("c", 0), ("a", None)]
    assert all(isinstance(s, int) and isinstance(e, int) and s <= e for *_n, s, e in t.spans)
    assert t.counters == {"n": 3} and t.counts["a"] == 2
    assert t.totals["a"] == pytest.approx(sum(e - s for n, _p, s, e in t.spans if n == "a") / 1e9)


def test_spans_and_counts_outside_a_run_do_nothing():
    before = profiling.recent_runs()
    with profiling.span("loose"):
        profiling.count("loose")
    assert list(profiling.spans_over([1, 2], "loose")) == [1, 2]
    assert profiling.recent_runs() == before


def test_a_run_records_and_recent_runs_is_bounded():
    res, rec = _one_record(lambda: _Driver().run(["x", "y"]))
    assert _names(rec["spans"]) == ["run", "x", "y"]
    _well_nested(rec["spans"])
    assert rec["counts"] == {"calls": 2}
    for _ in range(profiling.RECENT_RUNS + 2):
        last = _Driver().run(["x"])
    recent = profiling.recent_runs()
    assert len(recent) == profiling.RECENT_RUNS
    numbers = [r["run"] for r in recent]
    assert numbers == list(range(numbers[0], numbers[0] + profiling.RECENT_RUNS))
    assert recent[-1]["spans"] == last.timings["spans"]


def test_a_run_inside_a_run_records_into_it():
    _res, rec = _one_record(lambda: _Driver().run(["outer"], inner=_Driver()))
    assert _names(rec["spans"]) == ["run", "outer", "inner"]
    _well_nested(rec["spans"])
    assert rec["counts"] == {"calls": 2}


class _Loop:
    @profiling.recorded
    def run(self, items):
        return SimpleNamespace(timings={}, out=list(profiling.spans_over(items, "frame",
                                                                          first="init")))


def test_spans_over_wraps_each_item_and_not_the_iterator():
    pulled = []

    def items():
        for k in range(3):
            pulled.append(time.time_ns())
            yield k

    res = _Loop().run(items())
    assert res.out == [0, 1, 2]
    spans = res.timings["spans"]
    _well_nested(spans)
    assert [(n, p) for n, p, _s, _e in spans] == [("run", None), ("init", 0), ("frame", 0),
                                                  ("frame", 0)]
    for (_n, _p, start, _e), at in zip(spans[1:], pulled):
        assert at <= start
    for (_n, _p, _s, end), at in zip(spans[1:], pulled[1:]):
        assert end <= at


def test_a_span_is_a_profiler_range_only_while_a_profiler_records(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    t = StageTimer()
    with t.stage("quiet"):
        torch.ones(8).sum()
    assert opened == []
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        with t.stage("loud"):
            torch.ones(8).sum()
    assert opened == ["loud"]
    events = [e for e in prof.kineto_results.events() if e.name() == "loud"]
    assert len(events) == 1
    assert abs(events[0].start_ns() - t.spans[-1][2]) <= 1_000_000


def test_scan_runner_spans(clip):
    res, rec = _one_record(lambda: ScanSpeedRunner(_cfg(), device="cpu").run(
        clip.reader, annotation=clip.annotation, n_frames=RUN, verbose=False, lean=True))
    spans = rec["spans"]
    _well_nested(spans)
    assert _names(spans)[:6] == ["run", "decode", "upload", "init", "init.features",
                                 "init.geometry"]
    assert _children(spans, "init") == {"run": 1}
    assert _children(spans, "init.features") == {"init": 1}
    assert _children(spans, "init.geometry") == {"init": 1}
    assert _children(spans, "segment") == {"run": 2}
    assert _children(spans, "segment.read") == {"run": 2}
    assert _children(spans, "step") == {"segment": RUN - 1}
    assert _children(spans, "reanchor") == {"run": 1}
    assert not {"frame", "rescue", "graph.capture"} & set(_names(spans))
    assert rec["counts"]["reanchor.iterations"] > 0
    assert rec["counts"].get("graph.captures", 0) == 0

    # the marks keep their meanings: decode_s and init_s count from the
    # run's start, msv_s spans the re-anchor and what follows it
    first = {}
    for name, _p, start, end in spans:
        first.setdefault(name, (start, end))
    run0 = spans[0][2]
    seg_a, seg_b = [s for s in spans if s[0] == "segment"]
    read_a = next(s for s in spans if s[0] == "segment.read")
    tm = res.timings
    eps = 1e-4
    assert first["upload"][1] - first["decode"][0] <= 1e9 * (tm["decode_s"] + eps)
    assert tm["decode_s"] <= (first["init"][0] - run0) / 1e9 + eps
    assert first["init"][1] - first["decode"][0] <= 1e9 * (tm["init_s"] + eps)
    assert tm["init_s"] <= (seg_a[2] - run0) / 1e9 + eps
    assert first["reanchor"][1] - first["reanchor"][0] <= 1e9 * (tm["msv_s"] + eps)
    assert tm["msv_s"] <= (seg_b[2] - read_a[3]) / 1e9 + eps


def _per_frame_driver_spans(spans, counts, n):
    _well_nested(spans)
    assert _children(spans, "init") == {"run": 1}
    assert _children(spans, "frame") == {"run": n - 1}
    assert _names(spans).index("init") < _names(spans).index("frame")
    assert _children(spans, "init.features") == {"init": 1}
    assert _children(spans, "init.geometry") == {"init": 1}
    assert _children(spans, "frame.upload") == {"init": 1, "frame": n - 1}
    assert _children(spans, "step") == {"frame": n - 1}
    assert _children(spans, "frame.wait") == {"frame": n - 1}
    assert _children(spans, "reanchor") == {"frame": 1}
    assert counts["reanchor.iterations"] > 0
    assert counts.get("graph.captures", 0) == 0
    # the re-anchor runs in the MSV frame's span, frame k being the k-th frame
    frames = [j for j, s in enumerate(spans) if s[0] == "frame"]
    assert next(s for s in spans if s[0] == "reanchor")[1] == frames[MSV - 1]


def test_per_frame_driver_spans(clip):
    _res, rec = _one_record(lambda: SpeedEstimator(_cfg(), device="cpu").run(
        clip.reader, annotation=clip.annotation, n_frames=RUN, verbose=False, lean=True))
    _per_frame_driver_spans(rec["spans"], rec["counts"], RUN)
    assert "rescue" not in _names(rec["spans"])


def test_stills_driver_spans(burst):
    # few strong corners, so lanes die and are re-seeded from the MSV frame on
    cfg = dataclasses.replace(_cfg(car_affine=True, harris_quality=0.6), native_scale=1.0)
    _res, rec = _one_record(lambda: StillsSpeedEstimator(cfg, device="cpu").run(
        _first_stills(burst, RUN + 1), annotation=burst.annotation, verbose=False))
    spans = rec["spans"]
    _per_frame_driver_spans(spans, rec["counts"], RUN + 1)
    # re-seeding from the MSV frame to the last but one, promotion after it
    assert _children(spans, "replenish") == {"frame": RUN - MSV}
    assert set(_children(spans, "promote")) == {"frame"}
    assert _children(spans, "georegister") == {"run": 1}


def test_a_clip_handed_to_the_driver_is_one_run(clip):
    """Stage 2 collapses on every frame, so the scan runner hands the clip
    to the per-frame driver, which rescues each frame: one record holds
    both, the driver's spans under the scan runner's ``run``."""

    def matcher(im_prev, im_cur, pts, valid):
        return clip.motion_affine(clip.frame_index(im_prev), clip.frame_index(im_cur))

    n = MSV + 1
    _res, rec = _one_record(lambda: ScanSpeedRunner(
        _cfg(min_affine_inliers=ALWAYS), device="cpu", fallback_matcher=matcher).run(
        clip.reader, annotation=clip.annotation, n_frames=n, verbose=False))
    spans = rec["spans"]
    _well_nested(spans)
    assert _children(spans, "init") == {"run": 2}
    assert _children(spans, "step") == {"segment": n - 1, "frame": n - 1}
    assert _children(spans, "frame") == {"run": n - 1}
    assert _children(spans, "rescue") == {"frame": n - 1}
    assert _children(spans, "reanchor") == {"run": 1, "frame": 1}


@pytest.mark.cuda
def test_spans_share_the_device_trace_clock_on_card(clip):
    """A span around a kernel and a synchronise, traced with CUDA activity
    alone and read as the benchmark reads a trace, contains the kernel's
    device interval. A scan run captures its step's graph once; a second
    run at the same shapes captures none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device trace and the graph capture")
    from benchmark import trace as bench_trace
    from velocity_tpu_torch.pipeline.step_graph import release_step_graphs

    t = StageTimer()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()

    def spin():
        with t.stage("spin"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()

    _out, tr = bench_trace.traced(spin)
    (_name, start, end, _c), = [d for d in tr.device if "spin" in d[0]]
    _n, _p, s0, s1 = t.spans[-1]
    assert s0 <= start < end <= s1
    assert end - start > 1_000_000

    release_step_graphs()
    runner = ScanSpeedRunner(_cfg(), device="cuda")
    runs = [runner.run(clip.reader, annotation=clip.annotation, n_frames=N_FRAMES,
                       verbose=False) for _ in range(2)]
    release_step_graphs()
    assert [r.timings["counts"].get("graph.captures", 0) for r in runs] == [1, 0]
    for r in runs:
        _well_nested(r.timings["spans"])
        assert np.isfinite(r.B).all()
    assert _children(runs[0].timings["spans"], "graph.capture") == {"segment": 1}
    assert "graph.capture" not in _names(runs[1].timings["spans"])
