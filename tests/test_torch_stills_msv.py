"""Upstream's stills deployment on the port (``StillsSpeedEstimator.run`` with
the MSV re-anchor, ``anchor="msv"``, and ``SolverConfig(msv_solve="tracked")``),
on the CPU, on a small seeded burst: the scene of ``test_torch_stills.py``
(stills focal, ``native_scale=1.0``, 8 stills a third of a 30 fps clip
apart, the car at 40 km/h from 4 m), 270x480, msv_frame 3, 128 lanes.

- The re-anchor's translation and cloud against the plain reference of the
  MSV (``benchmark/reference/msv.py``) from the same start: ``compare``
  holds in float64 (the cost within ``COST_TOL`` of the reference's
  minimum, the cloud within ``CLOUD_TOL`` of its extent); the same solve
  in float32 misses both by more than 100x, so the tolerances see the
  precision the configuration states.
- The plate pose's phases: ``reanchor.plate_pose.polish`` (the candidate
  poses) and ``reanchor.plate_pose.score`` (their per-frame re-solves) lie
  inside ``reanchor.plate_pose`` and cover at least 90% of it, and the
  counter ``plate_pose.candidates`` is the number of candidates.
- Those spans and that counter change no bit: the stills run with the BA
  re-anchor and the video scan runner with the MSV give the same arrays as
  with the new spans and counter left out, which is the program before
  they were added.
"""

import contextlib

import numpy as np
import pytest
import torch

from benchmark.reference import msv as msv_ref
from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
from velocity_tpu_torch.geometry.projection import Intrinsics
from velocity_tpu_torch.pipeline import anchor
from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner
from velocity_tpu_torch.pipeline.stills import StillsSpeedEstimator
from velocity_tpu_torch.solvers import pose, triangulate
from velocity_tpu_torch.testing.synthetic_clip import render_clip
from velocity_tpu_torch.utils import profiling

torch.set_num_threads(1)

N_STILLS, WIDTH, HEIGHT, MSV = 8, 480, 270, 3
BURST = dict(speed_kmh=40.0, depth0_m=4.0, stride=3, filename="synthetic.JPG", native_scale=1.0)
NEW_SPANS = ("reanchor.plate_pose.polish", "reanchor.plate_pose.score")
NEW_COUNTER = "plate_pose.candidates"


def _cfg(anchor_kind="msv", msv_solve="tracked"):
    return PipelineConfig(
        solver=SolverConfig(dtype="float32", msv_solve=msv_solve), msv_frame=MSV,
        anchor=anchor_kind, native_scale=BURST["native_scale"],
        tracker=TrackerConfig(max_features=128, ransac_trials=64, car_affine=True,
                              harris_quality=0.12))


@pytest.fixture(scope="module")
def burst():
    return render_clip(n_frames=N_STILLS, width=WIDTH, height=HEIGHT, seed=0, **BURST)


def _stills_run(burst, cfg):
    return StillsSpeedEstimator(cfg, device="cpu").run(
        burst.stills(), annotation=burst.annotation, verbose=False)


@pytest.fixture(scope="module")
def msv_run(burst):
    """The run, with the MSV's problem and answer and the plate pose's
    candidates recorded."""
    rec = {}
    real_msv, real_cands = anchor.msv_refine_translation, pose.plate_pose_candidates

    def msv_spy(intr, pixels, mask, origins, config=SolverConfig(), **kw):
        out = real_msv(intr, pixels, mask, origins, config=config, **kw)
        rec["msv"] = (intr, pixels.clone(), mask.clone(), origins.clone(), config, out)
        return out

    def cands_spy(*a, **k):
        rec["candidates"] = real_cands(*a, **k)
        return rec["candidates"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(anchor, "msv_refine_translation", msv_spy)
        mp.setattr(pose, "plate_pose_candidates", cands_spy)
        res = _stills_run(burst, _cfg())
    return res, rec


def test_the_burst_msv_matches_the_reference(msv_run):
    res, rec = msv_run
    intr, pixels, mask, origins, config, out = rec["msv"]
    assert pixels.dtype == torch.float64 and config.msv_solve == "tracked"
    assert pixels.shape[0] == MSV + 1 and int(mask.sum()) >= 20
    f = (float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy))
    problem = (pixels.numpy(), mask.numpy(), origins.numpy())
    sol = msv_ref.solve(f, *problem, start="tracked")
    got = msv_ref.compare(f, *problem, out.t, out.points, sol)
    assert got["ok"], got
    assert res.timings["counts"]["msv.capped"] == 0
    assert 0 < out.iterations < 20
    assert np.isfinite(res.S[1:, 8]).all() and np.isfinite(res.B[:, 6:9]).all()
    # the same solve in float32 misses both tolerances by more than 100x
    i32 = Intrinsics(*(torch.tensor(float(v), dtype=torch.float32)
                       for v in (intr.fx, intr.fy, intr.cx, intr.cy, intr.skew)))
    r32 = triangulate.msv_refine_translation(i32, pixels.float(), mask, origins.float(), config)
    f32 = msv_ref.compare(f, *problem, r32.t.double(), r32.points.double(), sol)
    assert abs(f32["cost_excess"]) >= 100 * msv_ref.COST_TOL, f32
    assert f32["cloud_err"] >= 100 * msv_ref.CLOUD_TOL, f32


def test_the_plate_pose_phases_are_spanned_and_counted(msv_run):
    res, rec = msv_run
    spans, counts = res.timings["spans"], res.timings["counts"]
    names = [s[0] for s in spans]
    assert names.count("reanchor.plate_pose") == 1
    top = names.index("reanchor.plate_pose")
    _n, _p, start, end = spans[top]
    inner = 0
    for name in NEW_SPANS:
        assert names.count(name) == 1, names
        _n, parent, s0, s1 = spans[names.index(name)]
        assert parent == top and start <= s0 <= s1 <= end
        inner += s1 - s0
    assert names.index(NEW_SPANS[0]) < names.index(NEW_SPANS[1])
    assert inner >= 0.9 * (end - start), (inner, end - start)
    assert counts[NEW_COUNTER] == len(rec["candidates"]) >= 1


@contextlib.contextmanager
def _without_the_new_tracing():
    """The program with the plate pose's spans and counter left out."""
    real_span, real_count = profiling.span, profiling.count

    def span(name):
        return contextlib.nullcontext() if name in NEW_SPANS else real_span(name)

    def count(name, k=1):
        if name != NEW_COUNTER:
            real_count(name, k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "span", span)
        mp.setattr(profiling, "count", count)
        yield


def _same(a, b):
    """The same run bit for bit (``S``'s first two columns are the clock's)."""
    np.testing.assert_array_equal(a.B, b.B)
    np.testing.assert_array_equal(a.S[:, 2:], b.S[:, 2:])
    np.testing.assert_array_equal(a.track_px, b.track_px)
    np.testing.assert_array_equal(a.proj_px, b.proj_px)
    np.testing.assert_array_equal(a.valid, b.valid)


def _video_msv():
    clip = render_clip(n_frames=5, width=WIDTH, height=HEIGHT, seed=0)
    cfg = PipelineConfig(solver=SolverConfig(dtype="float32", msv_solve="tracked"),
                         msv_frame=MSV, tracker=TrackerConfig(max_features=64, ransac_trials=32))
    return ScanSpeedRunner(cfg, device="cpu").run(clip.reader, annotation=clip.annotation,
                                                  n_frames=5, verbose=False, lean=True)


@pytest.mark.parametrize("path", ["stills_ba", "video_msv"])
def test_the_new_tracing_changes_no_bit(burst, path):
    def run():
        if path == "stills_ba":
            return _stills_run(burst, _cfg("ba", msv_solve="upstream"))
        return _video_msv()

    now = run()
    with _without_the_new_tracing():
        before = run()
    _same(now, before)
    traced = {s[0] for s in now.timings["spans"]} & set(NEW_SPANS)
    assert traced == (set(NEW_SPANS) if path == "video_msv" else set())
    assert not {s[0] for s in before.timings["spans"]} & set(NEW_SPANS)
