"""The MSV re-anchor's readers (``msv_solve_ms``, ``plate_pose_ms``,
``msv_rejected_steps``, ``msv_capped``) on hand-made records of the
program's spans and counters, a program without them giving no reading;
and the plain MSV reference (``benchmark/reference/msv.py``), which runs on
the card's machine beside the program, loading nothing of the program or of
JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.reference import msv as msv_ref
from benchmark.tests.test_bench_imports import JAX, PORT, _loaded
from benchmark.tests.test_bench_metrics import _metric

M = 1_000_000  # ns in a ms


def _clip(plate_ms, msv_ms, rejected, capped):
    """A scan runner's record: the re-anchor at 100 ms holding the plate
    pose and then the MSV solve, with their counters."""
    spans = [("run", None, 0, 1000 * M), ("init", 0, 0, 50 * M),
             ("reanchor", 0, 100 * M, (101 + plate_ms + msv_ms) * M),
             ("reanchor.plate_pose", 2, 100 * M, (100 + plate_ms) * M),
             ("reanchor.msv", 2, (100 + plate_ms) * M, (100 + plate_ms + msv_ms) * M)]
    return {"timings": {"spans": spans, "counts": {"reanchor.iterations": 9,
                                                   "msv.rejected": rejected,
                                                   "msv.capped": capped}}, "pulls": []}


def test_msv_readers_on_hand_made_records():
    run = SimpleNamespace(clips=[_clip(60, 120, 2, 0), _clip(80, 300, 5, 1), _clip(70, 90, 0, 0)],
                          pcfg=SimpleNamespace(msv_frame=5), trace=None)
    assert _metric("plate_pose_ms").read(run) == pytest.approx(70.0)
    assert _metric("msv_solve_ms").read(run) == pytest.approx(170.0)
    assert _metric("msv_rejected_steps").read(run) == pytest.approx(7 / 3)
    assert _metric("msv_capped").read(run) == 1


@pytest.mark.parametrize("timings", [
    {"wall_s": 1.0},  # no record at all
    {"spans": [("run", None, 0, 10), ("reanchor", 0, 2, 5)],  # the BA re-anchor, or the parent
     "counts": {"reanchor.iterations": 8}},
])
def test_msv_readers_read_nothing_without_their_spans(timings):
    run = SimpleNamespace(clips=[{"timings": timings, "pulls": []}],
                          pcfg=SimpleNamespace(msv_frame=5), trace=None)
    for name in ("msv_solve_ms", "plate_pose_ms", "msv_rejected_steps", "msv_capped"):
        assert _metric(name).read(run) is None, name


def test_the_msv_reference_loads_nothing_of_the_program():
    loaded = _loaded(["benchmark.reference.msv"])
    assert not loaded & (JAX | {PORT}), loaded & (JAX | {PORT})


INTR = (1000.0, 1000.0, 500.0, 400.0)


def _plane_scene(noise):
    rng = np.random.default_rng(0)
    n, nf = 80, 6
    p = np.stack([rng.uniform(-0.5, 0.5, n) + 0.4, rng.uniform(-0.4, 0.2, n) + 0.3,
                  rng.uniform(2.9, 3.1, n)], 1)
    t = np.array([0.02, 0.0, 0.35])[None, :] * np.arange(nf)[:, None]
    fx, fy, cx, cy = INTR
    pix = np.stack([np.stack([fx * (p[:, 0] + tf[0]) / (p[:, 2] + tf[2]) + cx,
                              fy * (p[:, 1] + tf[1]) / (p[:, 2] + tf[2]) + cy], 1) for tf in t])
    mask = np.ones(n, bool)
    mask[::9] = False
    return p, t, pix + rng.normal(0.0, noise, pix.shape), mask


def test_the_msv_reference_finds_a_known_minimum():
    """Noise-free tracks of static points seen from a receding camera: the
    minimum is the true translation, at no cost, with the true cloud."""
    p, t, pix, mask = _plane_scene(0.0)
    sol = msv_ref.solve(INTR, pix, mask, t)
    assert np.abs(sol.t.numpy() - (t[-1] - t[0])).max() < 1e-9
    assert np.abs(sol.points.numpy()[mask] - (p + t[-1])[mask]).max() < 1e-8
    assert sol.rms_px < 1e-6 and sol.iterations < msv_ref.MAX_ITERS


def test_compare_holds_the_minimum_and_refuses_a_step_off_it():
    _p, t, pix, mask = _plane_scene(0.05)
    sol = msv_ref.solve(INTR, pix, mask, t)
    same = msv_ref.compare(INTR, pix, mask, t, sol.t, sol.points, sol)
    assert same["ok"] and same["t_err_m"] == 0.0 and abs(same["cost_excess"]) < 1e-15
    off_t = sol.t + torch.tensor([0.0, 0.0, 1e-4], dtype=torch.float64)
    off = msv_ref.compare(INTR, pix, mask, t, off_t, sol.points, sol)
    assert not off["ok"] and off["cost_excess"] > msv_ref.COST_TOL
    # the cloud of the translation it comes with, and only that, passes
    _c, cloud = msv_ref.objective(INTR, pix, mask, t, off_t)
    assert msv_ref.compare(INTR, pix, mask, t, off_t, cloud, sol)["cloud_err"] == 0.0
