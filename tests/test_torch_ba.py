"""The port's bundle adjustment against the JAX package (CPU), on the scene
of ``tests/test_ba.py`` (6 cameras on a line with small rotations, 40 points
6-10 m away, perturbed): the Jacobian blocks, the reduced camera system and
every solver in f64 (1e-8 relative, equal iteration counts) and f32 (1e-4);
the hand-written CG against JAX's iterates; then ``tests/test_ba.py``'s own
oracle tests on the port alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.sparse.linalg import cg as jax_cg

from velocity_tpu.config import BAConfig as JaxBAConfig
from velocity_tpu.geometry import Intrinsics as JaxIntrinsics
from velocity_tpu.solvers import ba as jax_ba
from velocity_tpu.solvers import schur as jax_schur
from velocity_tpu_torch.config import BAConfig
from velocity_tpu_torch.geometry.projection import Intrinsics
from velocity_tpu_torch.geometry.rotations import rpy_to_matrix, rpy_to_matrix_jacobian
from velocity_tpu_torch.solvers import ba, schur

torch.set_num_threads(1)

FX, CX, CY = 1993.89, 960.5, 540.5
DTYPES = {"float64": (torch.float64, jnp.float64, 1e-8),
          "float32": (torch.float32, jnp.float32, 1e-4)}


def _project_np(pc):
    return np.stack([FX * pc[..., 0] / pc[..., 2] + CX, FX * pc[..., 1] / pc[..., 2] + CY],
                    axis=-1)


def make_scene(nc=6, nt=40, noise_px=0.0, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-2, 2, (nt, 2)), rng.uniform(6, 10, (nt, 1))], axis=1)
    pos = np.stack([np.linspace(0, 1.8, nc), np.linspace(0, 0.15, nc),
                    np.linspace(0, 0.35, nc)], axis=1)
    rpy = np.zeros((nc, 3))
    rpy[1:] = rng.uniform(-0.02, 0.02, (nc - 1, 3))
    cams = np.concatenate([pos, rpy], axis=1)
    cams[0] = 0
    pix = np.zeros((nc, nt, 2))
    for c in range(nc):
        C = rpy_to_matrix(torch.as_tensor(rpy[c])).numpy()
        pix[c] = _project_np(pts @ C + pos[c])
    pix += rng.normal(0, noise_px, pix.shape)
    return pts, cams, pix, np.ones((nc, nt), bool)


def perturbed(noise_px=0.0, seed=0, nc=6, nt=40):
    """(pixels, mask, points0, cams0) numpy, true points, true cameras."""
    pts, cams, pix, mask = make_scene(nc, nt, noise_px, seed)
    rng = np.random.default_rng(seed + 1)
    pts0 = pts + rng.normal(0, 0.05, pts.shape)
    cams0 = cams.copy()
    cams0[1:, 0:3] += rng.normal(0, 0.03, (nc - 1, 3))
    cams0[1:, 3:6] += rng.normal(0, 0.005, (nc - 1, 3))
    return (pix, mask, pts0, cams0), pts, cams


def problem(arrays, dtype=torch.float64):
    pix, mask, pts0, cams0 = arrays
    intr = Intrinsics(*(torch.tensor(v, dtype=dtype) for v in (FX, FX, CX, CY, 0.0)))
    return ba.BAProblem(intr, torch.as_tensor(pix, dtype=dtype), torch.as_tensor(mask),
                        torch.as_tensor(pts0, dtype=dtype), torch.as_tensor(cams0, dtype=dtype))


def jax_problem(arrays, dtype=jnp.float64):
    pix, mask, pts0, cams0 = arrays
    intr = JaxIntrinsics(*(jnp.asarray(v, dtype) for v in (FX, FX, CX, CY, 0.0)))
    return jax_ba.BAProblem(intr, jnp.asarray(pix, dtype), jnp.asarray(mask),
                            jnp.asarray(pts0, dtype), jnp.asarray(cams0, dtype))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# ------------------------------------------------------------- against JAX


@pytest.mark.parametrize("fix_rotations", [False, True])
def test_compute_blocks_match_jax(fix_rotations):
    """r, A, B within 1e-10 absolute (f64); the rpy columns are zero where
    rotations are fixed, and camera 0 has no camera block."""
    arrays, _, _ = perturbed(noise_px=0.3)
    p, jp = problem(arrays), jax_problem(arrays)
    got = schur.compute_blocks(p.intr, p, p.points0, p.cams0, fix_rotations)
    want = jax_schur.compute_blocks(jp.intr, jp, jp.points0, jp.cams0, fix_rotations)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)
    assert not got.B[0].any()
    assert bool(got.B[1:, :, :, 3:].any()) != fix_rotations


def test_rotation_jacobian_matches_forward_mode():
    """The written-out derivative of rpy_to_matrix against forward-mode
    differentiation of it (1e-14), batched, laid out [i, j, param]."""
    rpy = torch.as_tensor(np.random.default_rng(3).uniform(-1.2, 1.2, (7, 3)))
    want = torch.func.vmap(torch.func.jacfwd(rpy_to_matrix))(rpy)
    got = rpy_to_matrix_jacobian(rpy)
    assert got.shape == (7, 3, 3, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-14)


def test_compute_blocks_mask_out_observations():
    arrays, _, _ = perturbed(noise_px=0.3)
    pix, mask, pts0, cams0 = arrays
    mask = mask.copy()
    mask[2, 5:9] = False
    p, jp = problem((pix, mask, pts0, cams0)), jax_problem((pix, mask, pts0, cams0))
    got = schur.compute_blocks(p.intr, p, p.points0, p.cams0)
    want = jax_schur.compute_blocks(jp.intr, jp, jp.points0, jp.cams0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)
        assert not g[2, 5:9].any()


def test_schur_reduce_matches_jax():
    """S, rhs (and Vinv, gp, W) within 1e-9 relative; the split functions
    assemble the same system and solve it as the dense factorization does."""
    arrays, _, _ = perturbed(noise_px=0.3)
    p, jp = problem(arrays), jax_problem(arrays)
    lam = 1.0 / FX ** 2
    blocks = schur.compute_blocks(p.intr, p, p.points0, p.cams0)
    jblocks = jax_schur.compute_blocks(jp.intr, jp, jp.points0, jp.cams0)
    got = schur.schur_reduce(blocks, lam, torch.float64)
    want = jax_schur.schur_reduce(jblocks, lam, jnp.float64)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-9
    S, rhs, Vinv, gp, W = got
    np.testing.assert_array_equal(S[:6, :6].numpy(), np.eye(6))
    assert not S[:6, 6:].any() and not S[6:, :6].any() and not rhs[:6].any()

    parts = schur.schur_camera_partials(blocks, *schur.schur_point_blocks(blocks, lam,
                                                                         torch.float64))
    jparts = jax_schur.schur_camera_partials(
        jblocks, *jax_schur.schur_point_blocks(jblocks, lam, jnp.float64))
    for g, w in zip(parts, jparts):
        assert _rel(g.numpy(), w) <= 1e-9
    dc = schur.schur_assemble_solve(*parts, lam, torch.float64)
    jdc = jax_schur.schur_assemble_solve(*jparts, lam, jnp.float64)
    assert _rel(dc.numpy(), jdc) <= 1e-9
    np.testing.assert_allclose(dc.numpy(), torch.linalg.solve(S, rhs).numpy(), atol=1e-12)
    assert _rel(schur.schur_backsub(Vinv, gp, W, dc).numpy(),
                jax_schur.schur_backsub(*want[2:], jdc)) <= 1e-9


@pytest.mark.parametrize("max_iters", [1, 3, 8, 200])
def test_cg_matches_jax_iterates(max_iters):
    """The hand-written Jacobi-preconditioned CG against
    jax.scipy.sparse.linalg.cg on the reduced camera system of the scene,
    stopped after 1, 3 and 8 iterations and run to its tolerance: the same
    iterate, 1e-9 relative. A zero diagonal entry preconditions with 1."""
    arrays, _, _ = perturbed(noise_px=0.3, nc=8, nt=48)
    p = problem(arrays)
    blocks = schur.compute_blocks(p.intr, p, p.points0, p.cams0)
    S, rhs, *_ = schur.schur_reduce(blocks, 1.0 / FX ** 2, torch.float64)
    jS, jb = jnp.asarray(S.numpy()), jnp.asarray(rhs.numpy())
    d = jnp.diagonal(jS)
    Minv = jnp.where(jnp.abs(d) > 0, 1.0 / d, 1.0)
    want, _ = jax_cg(lambda v: jS @ v, jb, tol=1e-10, maxiter=max_iters, M=lambda v: Minv * v)
    got = schur.cg_jacobi(S, rhs, 1e-10, max_iters)
    assert _rel(got.numpy(), want) <= 1e-9
    if max_iters == 200:
        assert _rel(got.numpy(), torch.linalg.solve(S, rhs).numpy()) <= 1e-8

    S0 = torch.diag(torch.tensor([2.0, 0.0, 4.0], dtype=torch.float64))
    b0 = torch.tensor([2.0, 0.0, 2.0], dtype=torch.float64)
    np.testing.assert_allclose(schur.cg_jacobi(S0, b0, 1e-12, 10).numpy(), [1.0, 0.0, 0.5])


SOLVERS = {
    "dense": (ba.ba_dense, jax_ba.ba_dense, {}, {}),
    "schur": (schur.ba_schur, jax_schur.ba_schur, {}, {}),
    "schur_cg": (schur.ba_schur, jax_schur.ba_schur, {},
                 dict(camera_solver="cg", cg_tol=1e-12, cg_max_iters=200)),
    "schur_fix_rotations": (schur.ba_schur, jax_schur.ba_schur, dict(fix_rotations=True), {}),
    "constrained": (ba.ba_constrained, jax_ba.ba_constrained, {}, {}),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_solver_matches_jax(solver, dtype):
    """points, cams and residual_rms within 1e-8 (f64) or 1e-4 (f32)
    relative to JAX's, after the same number of iterations. In f32 the two
    dense-Jacobian solvers are compared in JAX's scale gauge: monocular BA
    leaves the global scale to the damping alone, and the rounding of the
    (3 nt + 6 nc)^2 normal equations lets it drift by ~1e-3 over the
    iterations, the same factor on every point and camera position."""
    fn, jfn, kwargs, cfg = SOLVERS[solver]
    tdt, jdt, tol = DTYPES[dtype]
    arrays, _, _ = perturbed(noise_px=0.3)
    got = fn(problem(arrays, tdt), BAConfig(max_iters=8, **cfg), **kwargs)
    want = jfn(jax_problem(arrays, jdt), JaxBAConfig(max_iters=8, **cfg), **kwargs)
    assert got.points.dtype == tdt and np.asarray(want.points).dtype == np.dtype(dtype)
    assert got.iterations == int(want.iterations)
    points, cams = got.points.numpy(), got.cams.numpy().copy()
    if dtype == "float32" and fn is not schur.ba_schur:
        gauge = np.linalg.norm(np.asarray(want.cams)[1, 0:3]) / np.linalg.norm(cams[1, 0:3])
        assert abs(gauge - 1.0) < 5e-3
        points = points * gauge
        cams[:, 0:3] *= gauge
    assert _rel(points, want.points) <= tol
    assert _rel(cams, want.cams) <= tol
    assert abs(float(got.residual_rms) - float(want.residual_rms)) <= tol * float(
        want.residual_rms)
    if kwargs.get("fix_rotations"):
        # damped translation-only cameras: the rpy deltas are exactly zero
        np.testing.assert_array_equal(got.cams[:, 3:6].numpy(), arrays[3][:, 3:6].astype(dtype))


def test_residual_rms_matches_jax():
    arrays, _, _ = perturbed(noise_px=0.5)
    p, jp = problem(arrays), jax_problem(arrays)
    got = float(ba.ba_residual_rms(p, p.points0, p.cams0))
    assert abs(got - float(jax_ba.ba_residual_rms(jp, jp.points0, jp.cams0))) <= 1e-10 * got


# ------------------------------------- the oracle tests of tests/test_ba.py


def _align_scale(res, cams):
    """Monocular BA has a free global-scale gauge (camera 0 pinned only);
    align the recovered scale to truth via camera 1's baseline."""
    s = np.linalg.norm(res.cams.numpy()[1, 0:3]) / np.linalg.norm(cams[1, 0:3])
    return res.points.numpy() / s, res.cams.numpy()[:, 0:3] / s


class TestDenseBA:
    def test_noiseless_recovery(self):
        arrays, pts, cams = perturbed()
        res = ba.ba_dense(problem(arrays), BAConfig(max_iters=40, tol=1e-12))
        assert float(res.residual_rms) < 1e-8, float(res.residual_rms)
        pts_al, pos_al = _align_scale(res, cams)
        np.testing.assert_allclose(pts_al, pts, atol=1e-6)
        np.testing.assert_allclose(pos_al, cams[:, 0:3], atol=1e-6)

    def test_camera0_pinned(self):
        arrays, _, _ = perturbed()
        res = ba.ba_dense(problem(arrays), BAConfig(max_iters=5))
        np.testing.assert_array_equal(res.cams.numpy()[0], 0.0)

    def test_noisy_improves(self):
        arrays, _, _ = perturbed(noise_px=0.5)
        prob = problem(arrays)
        before = float(ba.ba_residual_rms(prob, prob.points0, prob.cams0))
        res = ba.ba_dense(prob, BAConfig(max_iters=20))
        assert float(res.residual_rms) < before
        assert float(res.residual_rms) < 0.6  # ~ noise floor


class TestSchurBA:
    def test_equals_dense(self):
        """Schur reduction must reproduce the dense normal-equation iterates."""
        arrays, _, _ = perturbed(noise_px=0.3)
        cfg = BAConfig(max_iters=8)
        d = ba.ba_dense(problem(arrays), cfg)
        s = schur.ba_schur(problem(arrays), cfg)
        assert d.iterations == s.iterations
        np.testing.assert_allclose(s.points.numpy(), d.points.numpy(), atol=1e-8)
        np.testing.assert_allclose(s.cams.numpy(), d.cams.numpy(), atol=1e-8)

    def test_noiseless_recovery(self):
        arrays, pts, cams = perturbed()
        res = schur.ba_schur(problem(arrays), BAConfig(max_iters=40, tol=1e-12))
        assert float(res.residual_rms) < 1e-8
        pts_al, _ = _align_scale(res, cams)
        np.testing.assert_allclose(pts_al, pts, atol=1e-6)

    def test_masked_observations_inert(self):
        arrays, _, _ = perturbed(noise_px=0.2)
        pix, mask, pts0, cams0 = arrays
        # corrupt 30% of observations but mask them out
        rng = np.random.default_rng(9)
        bad = rng.uniform(size=mask.shape) < 0.3
        bad[:, :4] = False  # keep a core of clean tracks
        pix, mask = pix.copy(), mask.copy()
        pix[bad] += 1000.0
        mask[bad] = False
        res = schur.ba_schur(problem((pix, mask, pts0, cams0)), BAConfig(max_iters=15))
        assert float(res.residual_rms) < 0.5

    def test_larger_problem(self):
        arrays, _, _ = perturbed(nc=10, nt=256)
        res = schur.ba_schur(problem(arrays), BAConfig(max_iters=25))
        assert float(res.residual_rms) < 1e-5


class TestConstrainedBA:
    def test_straight_line_recovery(self):
        """Cameras on a line, shared orientation: the straight-line prior."""
        nc, nt = 6, 50
        rng = np.random.default_rng(2)
        pts = np.concatenate([rng.uniform(-2, 2, (nt, 2)), rng.uniform(6, 10, (nt, 1))],
                             axis=1)
        direction = np.array([0.9, 0.1, 0.42])
        direction /= np.linalg.norm(direction)
        pos = np.linspace(0, 2.0, nc)[:, None] * direction
        pix = np.stack([_project_np(pts + pos[c]) for c in range(nc)])
        pts0 = pts + rng.normal(0, 0.03, pts.shape)
        cams0 = np.concatenate([pos + rng.normal(0, 0.02, pos.shape), np.zeros((nc, 3))],
                               axis=1)
        res = ba.ba_constrained(problem((pix, np.ones((nc, nt), bool), pts0, cams0)),
                                BAConfig(max_iters=15))
        assert float(res.residual_rms) < 1e-4, float(res.residual_rms)
        np.testing.assert_allclose(res.cams.numpy()[:, 0:3], pos, atol=1e-3)
        np.testing.assert_array_equal(res.cams.numpy()[:, 3:6], 0.0)


class TestCGCameraSolver:
    def test_cg_matches_dense(self):
        arrays, _, _ = perturbed(noise_px=0.3, nc=8, nt=48)
        dense = schur.ba_schur(problem(arrays), BAConfig(max_iters=6))
        cgres = schur.ba_schur(problem(arrays), BAConfig(max_iters=6, camera_solver="cg",
                                                         cg_tol=1e-12, cg_max_iters=200))
        np.testing.assert_allclose(cgres.cams.numpy(), dense.cams.numpy(), atol=1e-6)
        np.testing.assert_allclose(cgres.points.numpy(), dense.points.numpy(), atol=1e-6)
