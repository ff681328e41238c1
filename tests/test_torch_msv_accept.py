"""The MSV re-anchor's "tracked" solve (``SolverConfig.msv_solve``: start at
the newest camera's tracked translation, an LM that keeps a step only where
the cost fell, ``solvers/lm.py:_lm_solve_accepted``) against the
benchmark's plain reference of the same objective
(``benchmark/reference/msv.py``), on the CPU.

- On 8 seeded scenes (6 frames, 64-256 tracks, about 15% masked) the
  tracked ``msv_refine_translation`` agrees with the reference from the
  same start: ``msv_ref.compare`` holds (the cost at the program's
  translation within ``COST_TOL`` = 1e-9 of the reference's minimum, its
  cloud within ``CLOUD_TOL`` = 1e-10 of the cloud's extent from the
  reference's intercept there), and the translation lies within ``T_TOL``
  = 1e-8 m of the reference's minimiser. Why these numbers: the LM's stop
  is a step of rms 1e-8 m, so its translation is good to about that; the
  cost carries rounding noise of a few 1e-12 of itself (the intercept's
  1 - d^2 of nearly parallel rays), which 1e-9 clears by two orders; the
  cloud is the same arithmetic in another order. Float64 reads at most
  6.1e-10 m, 1.6e-12 and 4.7e-12 here. The same solve in float32 misses
  each by more than 100x (at least 3.0e-6 m, 1.4e-5 and 3.9e-3), which
  the test asserts.
- On a scene that recedes nearly along the line of sight with a lateral
  drift, the case ``tests/test_torch_multivideo.py`` steers clear of: from
  upstream's start (1 m beyond the previous camera) taking every step
  cycles to the cap far from any minimum, while accepted steps converge
  under the cap to the reference's minimum from that start; that minimum
  is a basin far from the truth, and the tracked start reaches the minimum
  that fits every track, in a few iterations. (On the benchmark's video
  clips 11 of 60 are such; ``PERF.md``.)
- With the field at its default the MSV is bit-equal to the take-every-step
  loop as it was before the accepted form existed (a verbatim copy below).
- The accepted form has no captured form: under ``fixed_trips()`` it raises.
- The tracked solve's closed forms: ``pairwise_intercept_affine`` is
  ``pairwise_intercept`` as an affine map of the newest origin, and its
  residual's Jacobian is the forward-mode one, to rounding; the plate
  pose's host solves (``_polish_pose_np``, ``solve_translation_np``), their
  forward differences batched, give the bits of their loops as they were
  (verbatim copies below).
- In a driver's run the MSV branch records the spans ``reanchor.plate_pose``
  and ``reanchor.msv`` inside ``reanchor`` and the counters
  ``msv.rejected`` and ``msv.capped``.
"""

import numpy as np
import pytest
import torch
from torch.func import jacfwd

from benchmark.reference import msv as msv_ref
from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
from velocity_tpu_torch.geometry.projection import Intrinsics
from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner
from velocity_tpu_torch.solvers import lm, pose, triangulate
from velocity_tpu_torch.testing.synthetic_clip import render_clip
from velocity_tpu_torch.utils.loops import fixed_trip_loops

torch.set_num_threads(1)

F = (1200.0, 1200.0, 640.0, 360.0)  # fx, fy, cx, cy
T_TOL = 1e-8  # m
SEEDS = [0, 1, 2, 3, 4, 6, 7, 8]  # 64 + 24 * seed tracks


def _scene(seed, n, t0=(0.6, 0.45, 3.0), step=(0.02, 0.0, 0.37), nf=6, noise=0.05):
    """A planar car rear (turned about the vertical) receding from a static
    camera by ``step`` a frame: (pixels (nf, n, 2), mask (n,), origins (nf, 3))."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = F
    a = rng.uniform(-0.15, 0.15)
    R = np.array([[np.cos(a), 0.0, -np.sin(a)], [0.0, 1.0, 0.0], [np.sin(a), 0.0, np.cos(a)]])
    pw = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.7, 0.3, n), np.zeros(n)], 1)
    p3 = pw @ R + np.asarray(t0)
    t_rel = np.asarray(step)[None, :] * np.arange(nf)[:, None]
    pix = np.stack([np.stack([fx * (p3[:, 0] + t[0]) / (p3[:, 2] + t[2]) + cx,
                              fy * (p3[:, 1] + t[1]) / (p3[:, 2] + t[2]) + cy], 1)
                    for t in t_rel])
    pix = pix + rng.normal(0.0, noise, pix.shape)
    return pix, rng.random(n) > 0.15, np.asarray(t0) + t_rel


def _args(scene, dtype=torch.float64):
    pix, mask, origins = scene
    intr = Intrinsics(*(torch.tensor(v, dtype=dtype) for v in (*F, 0.0)))
    return (intr, torch.as_tensor(pix, dtype=dtype), torch.as_tensor(mask),
            torch.as_tensor(origins, dtype=dtype))


def _msv(scene, dtype=torch.float64, **solver):
    return triangulate.msv_refine_translation(*_args(scene, dtype), SolverConfig(**solver))


def _compare(scene, res, sol):
    return msv_ref.compare(F, *scene, res.t.double(), res.points.double(), sol)


def _upstream_start(scene):
    _pix, _mask, origins = scene
    return torch.as_tensor(np.array([0.0, 0.0, 1.0]) + origins[-2] - origins[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_tracked_msv_matches_the_reference(seed):
    scene = _scene(seed, 64 + 24 * seed)
    sol = msv_ref.solve(F, *scene, start="tracked")
    res = _msv(scene, msv_solve="tracked")
    got = _compare(scene, res, sol)
    assert got["ok"], got
    assert got["t_err_m"] <= T_TOL, got
    assert 0 < res.iterations < 10 and res.residual_rms * F[0] == pytest.approx(sol.rms_px,
                                                                              rel=1e-6)
    # float32 misses every tolerance by more than 100x
    f32 = _compare(scene, _msv(scene, torch.float32, msv_solve="tracked"), sol)
    assert abs(f32["cost_excess"]) >= 100 * msv_ref.COST_TOL, f32
    assert f32["cloud_err"] >= 100 * msv_ref.CLOUD_TOL, f32
    assert f32["t_err_m"] >= 100 * T_TOL, f32


def test_a_receding_scene_from_upstreams_start_and_from_the_track():
    """Tracks near the point the car recedes from have nearly parallel rays,
    whose intercepts swing metres as the newest camera moves: the objective
    has a basin far from the truth, which upstream's start falls into."""
    scene = _scene(100, 256, t0=(0.1, 0.05, 3.0), step=(0.03, 0.003, 0.37))
    _pix, _mask, origins = scene
    truth = origins[-1] - origins[0]
    x0 = _upstream_start(scene)
    there = msv_ref.solve(F, *scene, start="upstream")
    cap = 300  # the default form's 1,000 iterations end as far off
    every = triangulate.msv_refine_translation(*_args(scene), SolverConfig(max_iters_msv=cap))
    assert every.iterations == cap
    far = _compare(scene, every, there)
    assert far["cost_excess"] > 1e-3 and far["t_err_m"] > 1e-3, far
    accepted = triangulate.msv_refine_translation(
        *_args(scene), SolverConfig(msv_solve="tracked"), x0=x0)
    assert accepted.iterations < cap and accepted.rejected > 0
    assert _compare(scene, accepted, there)["ok"]
    assert np.abs(there.t.numpy() - truth).max() > 0.01 and there.rms_px > 1.0

    sol = msv_ref.solve(F, *scene, start="tracked")
    res = _msv(scene, msv_solve="tracked")
    got = _compare(scene, res, sol)
    assert got["ok"] and got["t_err_m"] <= T_TOL, got
    assert res.iterations < 10
    assert np.abs(sol.t.numpy() - truth).max() < 1e-3 and sol.rms_px < 0.1
    assert sol.cost < there.cost / 100


def _lm_solve_before(residual_fn, x0, *, max_iters=30, damping=1.0, tol=1e-8, ramp_rate=0.2,
                     use_ramp=True, num_residuals=None):
    """``lm_solve``'s one-vector eager loop as it was before the accepted
    form was added, copied verbatim."""
    dtype = x0.dtype
    dev = x0.device
    nx = x0.shape[0]
    eye = torch.eye(nx, dtype=dtype, device=dev) * lm._scalar(damping, dtype, dev)
    tol = max(tol, 50.0 * float(torch.finfo(dtype).eps))
    jac = jacfwd(residual_fn)
    x = x0
    i = 0
    delta_rms = torch.full((), float("inf"), dtype=dtype, device=dev)
    while i < max_iters and bool(delta_rms >= tol):
        r, J = residual_fn(x), jac(x)
        g = -(J.T @ r)
        H = J.T @ J + eye
        delta = torch.linalg.solve_ex(H, g).result
        if use_ramp:
            delta = delta * lm._ramp(i, ramp_rate)
        rms = torch.sqrt(torch.sum(delta * delta) / delta.numel())
        x = x + delta
        delta_rms = rms
        i += 1
    r = residual_fn(x)
    if num_residuals is None:
        n = torch.full((), float(r.numel()), dtype=dtype, device=dev)
    else:
        n = torch.clamp(lm._scalar(num_residuals, dtype, dev), min=1.0)
    return lm.LMResult(x=x, iterations=i, delta_rms=delta_rms,
                       residual_rms=torch.sqrt(torch.sum(r * r) / n))


def _same(a, b):
    """Equal bits (masked tracks' points are NaN on both sides)."""
    assert a.dtype == b.dtype
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_default_is_bit_equal_to_the_loop_before(monkeypatch, dtype):
    """The MSV with the field at its default (on an easy and on a receding
    scene) and the ramped pose-style solve give the bits of the loop as it
    was."""
    scenes = [_scene(3, 136), _scene(100, 256, t0=(0.1, 0.05, 3.0), step=(0.03, 0.003, 0.37))]
    now = [_msv(s, dtype, max_iters_msv=60) for s in scenes]
    seen = []

    def before(residual_fn, x0, accept_steps=False, **kw):
        seen.append(accept_steps)
        return _lm_solve_before(residual_fn, x0, **kw)

    monkeypatch.setattr(triangulate, "lm_solve", before)
    then = [_msv(s, dtype, max_iters_msv=60) for s in scenes]
    assert seen == [False, False]
    for a, b in zip(now, then):
        assert a.iterations == b.iterations and a.rejected == 0
        _same(a.t, b.t)
        _same(a.points, b.points)
        _same(a.residual_rms, b.residual_rms)

    A = torch.tensor([[2.0, 0.3], [0.1, 1.5], [0.4, -0.2]], dtype=dtype)
    b = torch.tensor([1.0, -2.0, 0.5], dtype=dtype)

    def fn(x):
        return b - torch.tanh(A @ x)

    for kw in ({}, {"num_residuals": torch.tensor(2.0)}, {"use_ramp": False, "damping": 0.1}):
        got = lm.lm_solve(fn, torch.zeros(2, dtype=dtype), **kw)
        want = _lm_solve_before(fn, torch.zeros(2, dtype=dtype), **kw)
        assert got.iterations == want.iterations and got.rejected == 0
        for u, v in zip(got[:4], want):
            if isinstance(u, torch.Tensor):
                _same(u, v)


def test_accepted_steps_have_no_captured_form():
    scene = _scene(0, 64)
    with fixed_trip_loops():
        with pytest.raises(RuntimeError, match="no captured form"):
            _msv(scene, msv_solve="tracked")
        with pytest.raises(RuntimeError, match="no captured form"):
            lm.lm_solve(lambda x: x - 1.0, torch.zeros(2), use_ramp=False, accept_steps=True)
    with pytest.raises(ValueError, match="msv_solve"):
        _msv(scene, msv_solve="accepted")
    with pytest.raises(ValueError, match="ramp"):
        lm.lm_solve(lambda x: x - 1.0, torch.zeros(2), accept_steps=True)
    with pytest.raises(ValueError, match="one unknown vector"):
        lm.lm_solve(lambda x: x - 1.0, torch.zeros(2, 2), use_ramp=False, accept_steps=True)
    res = lm.lm_solve(lambda x: x - 1.0, torch.zeros(2, dtype=torch.float64), use_ramp=False,
                      accept_steps=True)
    assert torch.allclose(res.x, torch.ones(2, dtype=torch.float64), atol=1e-12)


def test_a_driver_run_records_the_msv_spans_and_counters():
    """The scan runner with the MSV re-anchor (the default ``anchor``) and
    the field on, over the first frames of a small clip: the MSV branch's
    phases inside ``reanchor``, its counters, and no cap."""
    clip = render_clip(n_frames=5, width=480, height=270, seed=0)
    cfg = PipelineConfig(solver=SolverConfig(dtype="float32", msv_solve="tracked"),
                         msv_frame=3, tracker=TrackerConfig(max_features=64, ransac_trials=32))
    res = ScanSpeedRunner(cfg, device="cpu").run(clip.reader, annotation=clip.annotation,
                                                 n_frames=5, verbose=False, lean=True)
    spans, counts = res.timings["spans"], res.timings["counts"]
    names = [s[0] for s in spans]
    assert names.count("reanchor") == 1
    anchor = names.index("reanchor")
    for name in ("reanchor.plate_pose", "reanchor.msv"):
        assert names.count(name) == 1, names
        _n, parent, start, end = spans[names.index(name)]
        assert parent == anchor and spans[anchor][2] <= start <= end <= spans[anchor][3]
    assert names.index("reanchor.plate_pose") < names.index("reanchor.msv")
    assert counts["msv.capped"] == 0
    assert 0 <= counts["msv.rejected"] < counts["reanchor.iterations"] < cfg.solver.max_iters_msv
    assert np.isfinite(res.S[1:, 8]).all()


@pytest.mark.parametrize("seed", [0, 5])
def test_the_closed_form_intercept_and_jacobian(monkeypatch, seed):
    """The cloud is C + M a in the last origin a, and the tracked solve's
    Jacobian is jacfwd's of its residual, to rounding."""
    pix, mask, origins = _scene(seed, 64 + 24 * seed)
    intr, pixels, m, org = _args((pix, mask, origins))
    rays = triangulate.pixel_to_unit_ray(intr, pixels)
    u0 = org[0][None, :] - org
    C, M = triangulate.pairwise_intercept_affine(u0[:-1], rays)
    rng = np.random.default_rng(seed)
    for a in torch.as_tensor(rng.normal(0.0, 1.0, (3, 3))):
        want = triangulate.pairwise_intercept(torch.cat([u0[:-1], a[None, :]]), rays)
        torch.testing.assert_close(C + M @ a, want, rtol=1e-9, atol=1e-9)
    seen = {}

    def spy(residual_fn, x0, jacobian_fn=None, **kw):
        seen["J"] = (jacobian_fn(x0), jacfwd(residual_fn)(x0))
        return lm.lm_solve(residual_fn, x0, jacobian_fn=jacobian_fn, **kw)

    monkeypatch.setattr(triangulate, "lm_solve", spy)
    _msv((pix, mask, origins), msv_solve="tracked")
    got, want = seen["J"]
    assert got.shape == want.shape == (2 * len(mask), 3)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="accepted-step"):
        lm.lm_solve(lambda x: x - 1.0, torch.zeros(2), jacobian_fn=lambda x: torch.eye(2))


def _polish_pose_before(intr, q, plate, R0, t0, iters=60, clamp=0.05):
    """``_polish_pose_np`` as it was before its projections were batched,
    copied verbatim."""
    fx, fy = float(intr.fx), float(intr.fy)
    cx, cy = float(intr.cx), float(intr.cy)
    sk = float(intr.skew)
    P = np.asarray(plate, np.float64)
    qn = np.asarray(q, np.float64)

    def project(R, t):
        pc = P @ R + t
        u = (fx * pc[:, 0] + sk * pc[:, 1]) / pc[:, 2] + cx
        v = fy * pc[:, 1] / pc[:, 2] + cy
        return np.stack([u, v], 1)

    def rot(w):
        th = np.linalg.norm(w)
        if th < 1e-12:
            return np.eye(3)
        a = w / th
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)

    R, t = np.asarray(R0, np.float64).copy(), np.asarray(t0, np.float64).copy()
    eps = 1e-6
    for _ in range(iters):
        r0 = (qn - project(R, t)).ravel()
        J = np.zeros((8, 6))
        for k in range(3):
            w = np.zeros(3)
            w[k] = eps
            J[:, k] = ((qn - project(R @ rot(w).T, t)).ravel() - r0) / eps
            dt = np.zeros(3)
            dt[k] = eps
            J[:, 3 + k] = ((qn - project(R, t + dt)).ravel() - r0) / eps
        g = J.T @ r0
        H = J.T @ J + np.eye(6) * 1e-9
        try:
            step = -np.linalg.solve(H, g)
        except np.linalg.LinAlgError:
            break
        step = np.clip(step, -clamp, clamp)
        R = R @ rot(step[:3]).T
        t = t + step[3:]
        if np.abs(step).max() < 1e-12:
            break
    U, _s, Vt = np.linalg.svd(R)
    R = U @ Vt
    return R, t


def _solve_translation_before(intr, pix, p3, t0, mask, max_iters=30, damping=1.0, tol=1e-8,
                              ramp_rate=0.2):
    """``solve_translation_np`` as it was before its forward differences
    were batched, copied verbatim."""
    fx, fy = float(intr.fx), float(intr.fy)
    cx, cy = float(intr.cx), float(intr.cy)
    sk = float(intr.skew)
    P = np.asarray(p3, np.float64)[mask]
    z = np.asarray(pix, np.float64)[mask].ravel()
    x = np.asarray(t0, np.float64).copy()
    inv_f = 1.0 / fx

    def zhat(t):
        pc = P + t
        u = (fx * pc[:, 0] + sk * pc[:, 1]) / pc[:, 2] + cx
        v = fy * pc[:, 1] / pc[:, 2] + cy
        return np.stack([u, v], 1).ravel()

    dx = 1e-6
    lam = damping * inv_f * inv_f
    for i in range(max_iters):
        r = (z - zhat(x)) * inv_f
        J = np.empty((r.size, 3))
        for k in range(3):
            e = np.zeros(3)
            e[k] = dx
            J[:, k] = ((z - zhat(x + e)) * inv_f - r) / dx
        JTJ = J.T @ J + np.eye(3) * lam
        step = np.linalg.solve(JTJ, J.T @ r)
        scale = min(((i + 1) * ramp_rate) ** 2, 1.0)
        x = x - step * scale
        if np.sqrt(np.mean(step * step)) * scale < tol:
            break
    res = (z - zhat(x))
    rms = np.sqrt(np.mean(res * res)) if res.size else 0.0
    return x, rms


def test_the_plate_poses_host_solves_keep_their_bits():
    """On 40 random plates, poses and track sets (some empty, some with
    skew) the batched polish and translation solve give the loops' bits."""
    rng = np.random.default_rng(7)
    for trial in range(40):
        f = rng.uniform(800.0, 3000.0)
        skew = 0.0 if trial % 3 else rng.uniform(-1.0, 1.0)
        intr = Intrinsics(*(torch.tensor(v, dtype=torch.float64) for v in (
            f, f * rng.uniform(0.99, 1.01), rng.uniform(400, 1000), rng.uniform(300, 600), skew)))
        plate = np.concatenate([rng.uniform(-0.2, 0.2, (4, 2)), np.zeros((4, 1))], 1)
        w = rng.uniform(-0.5, 0.5, 3)
        K = np.cross(np.eye(3), w / np.linalg.norm(w))
        th = np.linalg.norm(w)
        R0 = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
        t0 = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), rng.uniform(2.0, 8.0)])
        q = rng.uniform(200.0, 900.0, (4, 2))
        for got, want in zip(pose._polish_pose_np(intr, q, plate, R0, t0),
                             _polish_pose_before(intr, q, plate, R0, t0)):
            assert np.array_equal(got, want)
        n = int(rng.integers(0, 300)) if trial else 0
        p3 = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(2, 6, (n, 1))], 1)
        pix = rng.uniform(0.0, 1000.0, (n, 2))
        m = rng.random(n) > 0.2
        start = rng.normal(0.0, 0.1, 3)
        got = pose.solve_translation_np(intr, pix, p3, start, m)
        want = _solve_translation_before(intr, pix, p3, start, m)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
