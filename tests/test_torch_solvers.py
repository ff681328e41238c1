"""Mirrors of the JAX pose-solver and triangulation oracle tests
(``tests/test_solvers.py``: LM engine, plate-pose candidates, pose solvers,
triangulation, MSV) against the port's functions, with the same numpy
oracles, inputs (the same seed, drawn in the same order) and tolerances.
Where the JAX test checks ``jit``, the mirror checks that two calls give
the same bits.

The numpy twin reproduces the reference's LM algorithm (forward
differences dx=1e-6, identity damping, ramped steps) independently, to
confirm the analytic-Jacobian solvers land on the same optima.
"""

import numpy as np
import pytest
import torch

from velocity_tpu_torch.config import PipelineConfig, SolverConfig
from velocity_tpu_torch.geometry.plate import license_plate_points
from velocity_tpu_torch.geometry.projection import Intrinsics, world_to_image
from velocity_tpu_torch.geometry.rotations import rpy_to_matrix
from velocity_tpu_torch.pipeline.anchor import resolve_plate_pose
from velocity_tpu_torch.solvers.lm import lm_solve
from velocity_tpu_torch.solvers.pose import (
    _planar_pose_homography_np, estimate_world_camera_pose, plate_pose_candidates,
    solve_translation)
from velocity_tpu_torch.solvers.triangulate import (
    msv_refine_translation, nray_intercept, nray_intercept_masked_np, pairwise_intercept)

torch.set_num_threads(1)

RNG = np.random.default_rng(7)
F64 = torch.float64
T = torch.as_tensor


def _intr(*vals):
    return Intrinsics(*(torch.tensor(v, dtype=F64) for v in vals))


INTR = _intr(1993.89, 1993.89, 960.5, 540.5, 0.0)


def _project_np(intr, pc):
    u = (float(intr.fx) * pc[:, 0] + float(intr.skew) * pc[:, 1]) / pc[:, 2] + float(intr.cx)
    v = float(intr.fy) * pc[:, 1] / pc[:, 2] + float(intr.cy)
    return np.stack([u, v], axis=1)


def _twin_nls_t(intr, p, pw, x0):
    """Numpy twin of the reference 3-param LM (fwd-diff, ramped, damped)."""
    x = x0.astype(np.float64).copy()
    z = p.astype(np.float64).ravel()
    dx = 1e-6
    for i in range(30):
        b0 = pw + x
        zhat = _project_np(intr, b0).ravel()
        JT = np.zeros((3, z.size))
        for j in range(3):
            d = np.zeros(3)
            d[j] = dx
            JT[j] = (_project_np(intr, b0 + d).ravel() - zhat) / dx
        delta = np.linalg.solve(JT @ JT.T + np.eye(3), JT @ (z - zhat))
        delta *= min(((i + 1) * 0.2) ** 2, 1.0)
        x = x + delta
        if np.sqrt((delta**2).mean()) < 1e-8:
            break
    return x


def _t0():
    return torch.tensor([0.0, 0.0, 1.0], dtype=F64)


class TestLMEngine:
    def test_linear_problem_one_gn_step(self):
        """On a linear LSQ problem GN converges immediately (modulo ramp/damping)."""
        A = T(RNG.normal(size=(20, 3)))
        b = T(RNG.normal(size=20))
        x_star = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
        res = lm_solve(lambda x: b - A @ x, torch.zeros(3, dtype=F64), max_iters=50, tol=1e-12,
                       damping=1e-12, use_ramp=False)
        np.testing.assert_allclose(res.x.numpy(), x_star.numpy(), atol=1e-9)

    def test_ramp_limits_early_steps(self):
        """With the reference ramp, the first step is scaled by 0.04."""
        A = torch.eye(2, dtype=F64)
        b = torch.ones(2, dtype=F64)
        res = lm_solve(lambda x: b - A @ x, torch.zeros(2, dtype=F64), max_iters=1, damping=0.0,
                       use_ramp=True, tol=0.0)
        np.testing.assert_allclose(res.x.numpy(), 0.04 * np.ones(2), atol=1e-12)


class TestPlatePoseCandidates:
    """Planar-pose ambiguity machinery (solvers/pose.py)."""

    def _intr(self):
        return _intr(1993.9, 1993.9, 960.5, 540.5, 0.0)

    def _plate(self):
        return np.asarray(license_plate_points("Chile"), np.float64)

    def _quad(self, intr, plate, rpy, t):
        R = rpy_to_matrix(torch.tensor(rpy, dtype=F64))
        return R.numpy(), world_to_image(intr, R, T(t), T(plate)).numpy()

    def test_homography_pose_exact_on_clean_quad(self):
        intr, plate = self._intr(), self._plate()
        t = np.array([-1.0, -0.4, 4.0])
        R, q = self._quad(intr, plate, [0.3, -0.2, 0.1], t)
        Rh, th = _planar_pose_homography_np(intr, q, plate)
        np.testing.assert_allclose(Rh, R, atol=1e-10)
        np.testing.assert_allclose(th, t, atol=1e-10)

    def test_candidates_contain_truth_and_its_mirror(self):
        intr, plate = self._intr(), self._plate()
        t = np.array([-0.8, -0.3, 5.0])
        _, q = self._quad(intr, plate, [0.25, -0.3, 0.05], t)
        # ~1 px corner noise: enough to open the two-fold ambiguity
        q = q + np.array([[0.9, -0.7], [-0.8, 0.6], [0.7, 0.9], [-0.6, -0.8]])
        cands = plate_pose_candidates(intr, T(q), T(plate), SolverConfig())
        assert len(cands) >= 1
        # the branch nearest the true pose exists and is metrically close
        errs = [np.linalg.norm(c.t.numpy() - t) for c in cands]
        assert min(errs) < 0.25, errs
        # deterministic: a second call returns identical candidates
        cands2 = plate_pose_candidates(intr, T(q), T(plate), SolverConfig())
        assert len(cands) == len(cands2)
        for a, b in zip(cands, cands2):
            np.testing.assert_array_equal(a.t.numpy(), b.t.numpy())

    def test_resolve_plate_pose_picks_track_consistent_branch(self):
        intr, plate = self._intr(), self._plate()
        R = rpy_to_matrix(torch.tensor([0.25, -0.3, 0.05], dtype=F64))
        t0 = np.array([-0.8, -0.3, 5.0])
        # synthetic 6-frame plate track: the car recedes 0.4 m/frame
        k = 6
        track = np.full((k, 16, 2), np.nan)
        for f in range(k):
            tf = t0 + np.array([0.0, 0.0, 0.4]) * f
            track[f, 0:4] = world_to_image(intr, R, T(tf), T(plate)).numpy()
        q = track[0, 0:4] + np.array([[0.9, -0.7], [-0.8, 0.6], [0.7, 0.9], [-0.6, -0.8]])
        track[0, 0:4] = q  # frame-0 lanes are the (noisy) annotation
        _pose0, _p3c, t_rel, _res = resolve_plate_pose(intr, q, track, PipelineConfig())
        dx = np.linalg.norm(np.diff(t_rel, axis=0), axis=1)
        # the winner reproduces the 0.4 m/frame motion (the wrong branch would not)
        np.testing.assert_allclose(dx, 0.4, atol=0.05)


class TestPoseSolvers:
    def _scene(self, n=60, z0=8.0):
        pw = np.concatenate([RNG.uniform(-2, 2, (n, 2)), RNG.uniform(-0.5, 0.5, (n, 1))], axis=1)
        return pw, np.array([0.4, -0.3, z0])

    def test_translation_recovery_exact(self):
        pw, t_true = self._scene()
        p = _project_np(INTR, pw + t_true)
        res = solve_translation(INTR, T(p), T(pw), _t0())
        np.testing.assert_allclose(res.x.numpy(), t_true, atol=1e-7)
        assert float(res.residual_rms) < 1e-6

    def test_translation_matches_reference_twin(self):
        pw, t_true = self._scene(n=40)
        p = _project_np(INTR, pw + t_true) + RNG.normal(0, 0.5, (40, 2))  # noisy
        x_twin = _twin_nls_t(INTR, p, pw, np.array([0.0, 0.0, 1.0]))
        res = solve_translation(INTR, T(p), T(pw), _t0())
        np.testing.assert_allclose(res.x.numpy(), x_twin, atol=1e-5)

    def test_pose_rt_recovery_from_plate(self):
        """Frame-0 scenario: 6-DoF from the 4 plate corners."""
        plate = np.asarray(license_plate_points("Chile"), dtype=np.float64)
        t_true = np.array([0.2, 0.1, 6.0])
        C = rpy_to_matrix(torch.tensor([0.03, -0.06, 0.1], dtype=F64)).numpy()
        p = _project_np(INTR, plate @ C + t_true)
        pose = estimate_world_camera_pose(INTR, T(p), T(plate), find_R=True)
        np.testing.assert_allclose(pose.t.numpy(), t_true, atol=1e-6)
        np.testing.assert_allclose(pose.R.numpy(), C, atol=1e-6)
        assert float(pose.residual_rms) < 1e-6

    def test_masked_lanes_do_not_affect_solution(self):
        pw, t_true = self._scene(n=30)
        p = _project_np(INTR, pw + t_true)
        # append garbage lanes, masked out
        pw_pad = np.concatenate([pw, RNG.normal(size=(10, 3)) * 100], axis=0)
        p_pad = np.concatenate([p, np.full((10, 2), np.nan)], axis=0)
        # sanitize NaNs as the pipeline does before calling (the mask handles the rest)
        p_pad = np.nan_to_num(p_pad, nan=1e4)
        mask = np.concatenate([np.ones(30, bool), np.zeros(10, bool)])
        res = solve_translation(INTR, T(p_pad), T(pw_pad), _t0(), mask=T(mask))
        np.testing.assert_allclose(res.x.numpy(), t_true, atol=1e-7)

    def test_repeat_call_is_deterministic(self):
        """(JAX: ``test_jit_compiles``) the solve recovers the translation and
        a second call gives the same bits."""
        pw, t_true = self._scene(n=16)
        p = _project_np(INTR, pw + t_true)
        a = solve_translation(INTR, T(p), T(pw), _t0()).x
        b = solve_translation(INTR, T(p), T(pw), _t0()).x
        np.testing.assert_allclose(a.numpy(), t_true, atol=1e-7)
        assert torch.equal(a, b)


class TestTriangulation:
    def _rig(self, nf=6, n=50):
        pts = np.concatenate([RNG.uniform(-2, 2, (n, 2)), RNG.uniform(6, 10, (n, 1))], axis=1)
        cams = np.stack([np.linspace(0, 1.5, nf), np.zeros(nf), np.linspace(0, 0.3, nf)], axis=1)
        rays = np.zeros((nf, n, 3))
        for f in range(nf):
            d = pts - cams[f]
            rays[f] = d / np.linalg.norm(d, axis=1, keepdims=True)
        return pts, cams, rays

    def test_pairwise_exact(self):
        pts, cams, rays = self._rig()
        np.testing.assert_allclose(pairwise_intercept(T(cams), T(rays)).numpy(), pts, atol=1e-9)

    def test_nray_exact(self):
        pts, cams, rays = self._rig()
        np.testing.assert_allclose(nray_intercept(T(cams), T(rays)).numpy(), pts, atol=1e-9)

    def test_pairwise_vs_nray_with_noise(self):
        pts, cams, rays = self._rig()
        noisy = rays + RNG.normal(0, 1e-4, rays.shape)
        noisy /= np.linalg.norm(noisy, axis=2, keepdims=True)
        a = pairwise_intercept(T(cams), T(noisy)).numpy()
        b = nray_intercept(T(cams), T(noisy)).numpy()
        # different estimators, same neighborhood
        assert np.abs(a - b).max() < 0.02
        assert np.abs(a - pts).max() < 0.05

    def test_masked_nray_partial_histories_and_background(self):
        intr_np = (1000.0, 1000.0, 640.0, 360.0)
        fx, fy, cx, cy = intr_np
        nf, n = 5, 8
        pts = np.concatenate([RNG.uniform(-2, 2, (n, 2)), RNG.uniform(6, 10, (n, 1))], axis=1)
        tvecs = np.stack([np.zeros(nf), np.zeros(nf), np.linspace(0, 4.0, nf)], axis=1)
        track = np.full((nf, n, 2), np.nan)
        mask = np.zeros((nf, n), bool)
        for f in range(nf):
            pc = pts + tvecs[f]
            track[f, :, 0] = fx * pc[:, 0] / pc[:, 2] + cx
            track[f, :, 1] = fy * pc[:, 1] / pc[:, 2] + cy
            mask[f] = True
        # lane 0 observed only in the last 2 frames (replenished late)
        mask[:3, 0] = False
        track[:3, 0] = np.nan
        # lane 1 is static background: the same pixel every frame, consistent
        # only with a point at (near) infinity in the car frame
        track[:, 1, 0] = 700.0
        track[:, 1, 1] = 400.0
        p3, ok = nray_intercept_masked_np(intr_np, track, tvecs, mask)
        idx = np.r_[0, 2:n]
        assert ok[idx].all()
        # a near-axial baseline is weakly conditioned; sub-mm is ample
        np.testing.assert_allclose(p3[idx], pts[idx], atol=1e-3)
        # the world-static lane's rays are self-inconsistent in the car frame
        assert not ok[1]
        # a lane with a single observation is rejected
        mask1 = mask.copy()
        mask1[:4, 0] = False
        _, ok1 = nray_intercept_masked_np(intr_np, track, tvecs, mask1)
        assert not ok1[0] and ok1[2:].all()
        # the depth plausibility band rejects out-of-band lanes
        _, ok2 = nray_intercept_masked_np(intr_np, track, tvecs, mask, depth_range=(11.5, 100.0))
        assert not ok2[2:][pts[2:, 2] < 7.5].any()


class TestMSV:
    def test_refine_translation_recovers_camera(self):
        nf, n = 6, 80
        pts = np.concatenate([RNG.uniform(-2, 2, (n, 2)), RNG.uniform(6, 10, (n, 1))], axis=1)
        cams = np.stack([np.linspace(0, 1.8, nf), np.linspace(0, 0.1, nf),
                         np.linspace(0, 0.4, nf)], axis=1)  # camera positions, cam-0 frame
        pixels = np.zeros((nf, n, 2))
        for f in range(nf):
            pixels[f] = _project_np(INTR, pts - cams[f])
        # the driver passes B rows with u0 = B0 - Bf = cam_f - cam_0 => B_f = -cam_f
        res = msv_refine_translation(INTR, T(pixels), T(np.ones(n, bool)), T(-cams),
                                     SolverConfig(max_iters_msv=300))
        np.testing.assert_allclose(res.t.numpy(), -(cams[-1] - cams[0]), atol=1e-6)
        # the cloud is expressed relative to the newest camera
        np.testing.assert_allclose(res.points.numpy(), pts - cams[-1], atol=1e-5)
        assert float(res.residual_rms) < 1e-6

    def test_masked_lanes_sanitized(self):
        """NaN pixels in masked lanes must not poison the solve."""
        nf, n = 4, 20
        pts = np.concatenate([RNG.uniform(-1, 1, (n, 2)), RNG.uniform(5, 8, (n, 1))], axis=1)
        cams = np.stack([np.linspace(0, 1, nf), np.zeros(nf), np.zeros(nf)], axis=1)
        pixels = np.zeros((nf, n, 2))
        for f in range(nf):
            pixels[f] = _project_np(INTR, pts - cams[f])
        mask = np.ones(n, bool)
        mask[-5:] = False
        pixels[:, -5:, :] = np.nan
        res = msv_refine_translation(INTR, T(pixels), T(mask), T(-cams),
                                     SolverConfig(max_iters_msv=300))
        assert torch.isfinite(res.t).all()
        np.testing.assert_allclose(res.t.numpy(), -(cams[-1] - cams[0]), atol=1e-6)


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
