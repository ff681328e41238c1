"""The port's geometry and solvers against the JAX package (CPU).

Inputs are made with numpy from a seed and handed to both. f64 cases are the
host island (frame-0 plate solve, MSV): they agree to rounding. f32 cases
are the per-frame translation solve as the slice runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_tpu.geometry import projection as jproj
from velocity_tpu.geometry import rotations as jrot
from velocity_tpu.geometry.plate import license_plate_points
from velocity_tpu.solvers import pose as jpose
from velocity_tpu.solvers import triangulate as jtri
from velocity_tpu_torch.geometry import projection as tproj
from velocity_tpu_torch.geometry import rotations as trot
from velocity_tpu_torch.solvers import pose as tpose
from velocity_tpu_torch.solvers import triangulate as ttri

torch.set_num_threads(1)

INTR = (1994.0, 1994.0, 960.5, 540.5, 0.0)


def _intr(dtype):
    """The same intrinsics for both packages."""
    j = jproj.Intrinsics(*(jnp.asarray(v, dtype) for v in INTR))
    t = tproj.Intrinsics(*(torch.tensor(v, dtype=getattr(torch, dtype)) for v in INTR))
    return j, t


def _scene(seed=0, n=64, nf=6):
    """Plane points seen from a receding camera track, with pixel noise."""
    rng = np.random.default_rng(seed)
    R = np.asarray(jrot.rpy_to_matrix(jnp.asarray([0.05, -0.2, 0.1])))
    pw = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.7, 0.3, n), np.zeros(n)], 1)
    t0 = np.array([0.6, 0.45, 3.0])
    p3 = pw @ R + t0
    t_rel = np.stack([np.array([0.02, 0.0, 0.37]) * k for k in range(nf)])
    pix = []
    for t in t_rel:
        pc = p3 + t
        uv = np.stack([INTR[0] * pc[:, 0] / pc[:, 2] + INTR[2],
                       INTR[1] * pc[:, 1] / pc[:, 2] + INTR[3]], 1)
        pix.append(uv + rng.normal(0, 0.05, uv.shape))
    return R, t0, pw, p3, t_rel, np.array(pix)


def test_rotations_match_jax():
    rpy = np.random.default_rng(1).uniform(-0.6, 0.6, (10, 3))
    C = trot.rpy_to_matrix(torch.as_tensor(rpy))
    np.testing.assert_allclose(C.numpy(), np.asarray(jrot.rpy_to_matrix(jnp.asarray(rpy))),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(trot.matrix_to_rpy(C).numpy(),
                               np.asarray(jrot.matrix_to_rpy(jnp.asarray(C.numpy()))),
                               rtol=0, atol=1e-14)


def test_projection_matches_jax():
    """Projection, plane backprojection, rays and angles in f64: rounding only."""
    R, t0, pw, p3, _, pix = _scene()
    ji, ti = _intr("float64")
    C, t = torch.as_tensor(R), torch.as_tensor(t0)
    got = tproj.world_to_image(ti, C, t, torch.as_tensor(pw))
    want = jproj.world_to_image(ji, jnp.asarray(R), jnp.asarray(t0), jnp.asarray(pw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-9)
    got = tproj.image_to_world_plane(ti, C, t, torch.as_tensor(pix[0]))
    want = jproj.image_to_world_plane(ji, jnp.asarray(R), jnp.asarray(t0), jnp.asarray(pix[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    for fn in ("pixel_to_unit_ray", "pixel_to_angle"):
        got = getattr(tproj, fn)(ti, torch.as_tensor(pix))
        want = getattr(jproj, fn)(ji, jnp.asarray(pix))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-14)


@pytest.mark.parametrize("name", ["pairwise_intercept", "nray_intercept"])
def test_intercepts_match_jax(name):
    _, _, _, _, t_rel, pix = _scene()
    ji, ti = _intr("float64")
    rays_t = tproj.pixel_to_unit_ray(ti, torch.as_tensor(pix))
    origins = -t_rel
    got = getattr(ttri, name)(torch.as_tensor(origins), rays_t)
    want = getattr(jtri, name)(jnp.asarray(origins), jnp.asarray(rays_t.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-9)


def test_masked_nray_intercept_matches_jax():
    """The numpy twin is copied as it is: identical results."""
    _, _, _, _, t_rel, pix = _scene()
    mask = np.random.default_rng(2).random(pix.shape[:2]) > 0.2
    got = ttri.nray_intercept_masked_np(INTR[:4], pix, t_rel, mask)
    want = jtri.nray_intercept_masked_np(INTR[:4], pix, t_rel, mask)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_msv_refine_matches_jax():
    """MSV Gauss-Newton in f64 (the host island): the same iterate count and
    translation, cloud within 1e-9 m."""
    _, t0, _, _, t_rel, pix = _scene()
    ji, ti = _intr("float64")
    mask = np.ones(pix.shape[1], bool)
    mask[::7] = False
    origins = t0 + t_rel
    got = ttri.msv_refine_translation(ti, torch.as_tensor(pix), torch.as_tensor(mask),
                                      torch.as_tensor(origins))
    want = jtri.msv_refine_translation(ji, jnp.asarray(pix), jnp.asarray(mask),
                                       jnp.asarray(origins))
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0, atol=1e-9)


def test_plate_solve_matches_jax():
    """Frame-0 6-DoF plate solve (f64) and the planar-pose candidates."""
    R, t0, _, _, _, _ = _scene()
    ji, ti = _intr("float64")
    plate = license_plate_points("Chile").astype(np.float64)
    q = np.asarray(jproj.world_to_image(ji, jnp.asarray(R), jnp.asarray(t0), jnp.asarray(plate)))
    want = jpose.estimate_world_camera_pose(ji, jnp.asarray(q), jnp.asarray(plate), find_R=True)
    got = tpose.estimate_world_camera_pose(ti, torch.as_tensor(q), torch.as_tensor(plate),
                                           find_R=True)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0, atol=1e-9)
    jc = jpose.plate_pose_candidates(ji, jnp.asarray(q), jnp.asarray(plate))
    tc = tpose.plate_pose_candidates(ti, torch.as_tensor(q), torch.as_tensor(plate))
    assert len(tc) == len(jc)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.t.numpy(), np.asarray(b.t), rtol=0, atol=1e-9)


def test_translation_solve_matches_jax_f32():
    """The per-frame masked translation solve in f32, robust pass included:
    translation within 1e-5 m, residual within 1e-4 px (f32 sums in
    another order)."""
    _, t0, _, p3, t_rel, pix = _scene()
    ji, ti = _intr("float32")
    mask = np.ones(len(p3), bool)
    mask[::5] = False
    p = pix[3].astype(np.float32)
    p3f = p3.astype(np.float32)
    tw = np.asarray(t0, np.float32)
    want = jpose.estimate_world_camera_pose(ji, jnp.asarray(p), jnp.asarray(p3f),
                                            t0=jnp.asarray(tw), mask=jnp.asarray(mask))
    got = tpose.estimate_world_camera_pose(ti, torch.as_tensor(p), torch.as_tensor(p3f),
                                           t0=torch.as_tensor(tw), mask=torch.as_tensor(mask))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-5)
    assert abs(float(got.residual_rms) - float(want.residual_rms)) < 1e-4
    np.testing.assert_allclose(got.t.numpy(), t_rel[3], rtol=0, atol=5e-3)


# ---------------------------------------------------------------------------
# Mirrors of the JAX oracle tests (tests/test_geometry.py, rotations through
# norms): the same numpy oracles, inputs (the same seed, drawn in the same
# order) and tolerances, against the port's functions.

from velocity_tpu_torch.geometry import norms as tnorms  # noqa: E402
from velocity_tpu_torch.geometry import spherical as tsph  # noqa: E402
from velocity_tpu_torch.geometry.plate import license_plate_points as t_plate_points  # noqa: E402

RNG = np.random.default_rng(0)
T = torch.as_tensor


def _oracle_rpy2dcm(rpy):
    """Aerospace ZYX DCM composed from per-axis rotations, transposed into
    the row-vector convention (as tests/test_geometry.py)."""
    r, p, y = rpy
    Rx = np.array([[1, 0, 0], [0, np.cos(r), np.sin(r)], [0, -np.sin(r), np.cos(r)]])
    Ry = np.array([[np.cos(p), 0, -np.sin(p)], [0, 1, 0], [np.sin(p), 0, np.cos(p)]])
    Rz = np.array([[np.cos(y), np.sin(y), 0], [-np.sin(y), np.cos(y), 0], [0, 0, 1]])
    return (Rx @ Ry @ Rz).T


class TestRotations:
    def test_rpy_to_matrix_matches_axis_composition(self):
        for _ in range(20):
            rpy = RNG.uniform(-1.2, 1.2, 3)
            C = trot.rpy_to_matrix(T(rpy)).numpy()
            np.testing.assert_allclose(C, _oracle_rpy2dcm(rpy), atol=1e-12)

    def test_orthonormal(self):
        C = trot.rpy_to_matrix(T(RNG.uniform(-np.pi, np.pi, (50, 3))))
        eye = torch.eye(3, dtype=C.dtype).expand(C.shape)
        np.testing.assert_allclose((C @ C.transpose(-1, -2)).numpy(), eye.numpy(), atol=1e-12)
        np.testing.assert_allclose(np.linalg.det(C.numpy()), 1.0, atol=1e-12)

    def test_roundtrip(self):
        rpy = RNG.uniform(-1.2, 1.2, (100, 3))  # within atan/asin principal range
        rpy2 = trot.matrix_to_rpy(trot.rpy_to_matrix(T(rpy)))
        np.testing.assert_allclose(rpy2.numpy(), rpy, atol=1e-10)

    def test_rotate_translate(self):
        pts = RNG.normal(size=(7, 3))
        rpy = RNG.uniform(-1, 1, 3)
        t = RNG.normal(size=3)
        got = trot.rotate_translate(T(pts), T(rpy), T(t))
        np.testing.assert_allclose(got.numpy(), pts @ _oracle_rpy2dcm(rpy) + t, atol=1e-12)


def _random_intrinsics():
    fx, fy = RNG.uniform(1000, 4000, 2)
    cx, cy = RNG.uniform(500, 2000, 2)
    return tproj.Intrinsics(*(torch.tensor(v, dtype=torch.float64) for v in (fx, fy, cx, cy, 0.0)))


class TestProjection:
    def test_project_equals_rowvec_matmul(self):
        """project_camera_points == pscale(a @ K) with the MATLAB-layout K."""
        intr = _random_intrinsics()
        K = intr.matrix_rowvec(dtype=torch.float64).numpy()
        a = RNG.normal(size=(40, 3)) + np.array([0, 0, 10.0])
        want = (a @ K)[:, 0:2] / (a @ K)[:, 2:3]
        got = tproj.project_camera_points(intr, T(a))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)

    def test_from_matrix_roundtrip(self):
        intr = _random_intrinsics()
        intr2 = tproj.Intrinsics.from_matrix_rowvec(intr.matrix_rowvec(dtype=torch.float64))
        for a, b in zip(intr, intr2):
            np.testing.assert_allclose(float(a), float(b))

    def test_world_to_image_to_world_plane_roundtrip(self):
        """Backprojecting projections of z=0-plane points recovers their xy."""
        intr = _random_intrinsics()
        C = trot.rpy_to_matrix(T(RNG.uniform(-0.3, 0.3, 3)))
        t = torch.tensor([0.1, -0.2, 5.0], dtype=torch.float64)
        pw = np.concatenate([RNG.uniform(-1, 1, (30, 2)), np.zeros((30, 1))], axis=1)
        p = tproj.world_to_image(intr, C, t, T(pw))
        xy = tproj.image_to_world_plane(intr, C, t, p)
        np.testing.assert_allclose(xy.numpy(), pw[:, 0:2], atol=1e-9)

    def test_pixel_to_unit_ray(self):
        intr = _random_intrinsics()
        p = RNG.uniform(0, 3000, (20, 2))
        u = tproj.pixel_to_unit_ray(intr, T(p)).numpy()
        np.testing.assert_allclose(np.linalg.norm(u, axis=1), 1.0, atol=1e-12)
        # direction: the un-normalized ray is (p - c, fx)
        raw = np.concatenate([p - np.array([float(intr.cx), float(intr.cy)]),
                              np.full((20, 1), float(intr.fx))], axis=1)
        np.testing.assert_allclose(u, raw / np.linalg.norm(raw, axis=1, keepdims=True),
                                   atol=1e-12)

    def test_projection_of_ray_lands_on_pixel(self):
        intr = _random_intrinsics()
        intr = intr._replace(fy=intr.fx)  # pixel_to_unit_ray assumes fx == fy (reference parity)
        p = T(RNG.uniform(100, 2000, (15, 2)))
        p2 = tproj.project_camera_points(intr, tproj.pixel_to_unit_ray(intr, p) * 7.3)
        np.testing.assert_allclose(p2.numpy(), p.numpy(), atol=1e-9)

    def test_pixel_to_angle_shape(self):
        intr = _random_intrinsics()
        assert tproj.pixel_to_angle(intr, T(RNG.uniform(0, 3000, (11, 2)))).shape == (11, 2)


class TestSpherical:
    def test_roundtrip(self):
        x = RNG.normal(size=(64, 3))
        x2 = tsph.spherical_to_cartesian(tsph.cartesian_to_spherical(T(x)))
        np.testing.assert_allclose(x2.numpy(), x, atol=1e-12)

    def test_elaz_consistent_with_spherical(self):
        x = RNG.normal(size=(16, 3))
        s = tsph.cartesian_to_spherical(T(x)).numpy()
        np.testing.assert_allclose(tsph.elevation_azimuth(T(x)).numpy(), s[:, 1:3], atol=1e-12)


class TestPlate:
    def test_chile_plate(self):
        q = t_plate_points("Chile")
        assert q.shape == (4, 3)
        # width along x, height along y, clockwise from (+,-)
        np.testing.assert_allclose(q[:, 0], [0.18625, 0.18625, -0.18625, -0.18625])
        np.testing.assert_allclose(q[:, 1], [-0.06375, 0.06375, 0.06375, -0.06375])
        np.testing.assert_allclose(q[:, 2], 0)

    def test_eu_default(self):
        np.testing.assert_allclose(t_plate_points()[0], [0.260, -0.055, 0])


class TestNorms:
    def test_norm_rms(self):
        x = RNG.normal(size=(5, 4))
        np.testing.assert_allclose(float(tnorms.norm(T(x))), np.linalg.norm(x))
        np.testing.assert_allclose(float(tnorms.rms(T(x))), np.sqrt((x**2).mean()))
        u = tnorms.unit_rows(T(x)).numpy()
        np.testing.assert_allclose(np.linalg.norm(u, axis=1), 1.0)


def _helper_cases():
    """(name, port call, JAX call) of the small helpers on one seeded input."""
    from velocity_tpu.geometry import norms as jnorms

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 3))
    mask = rng.random((2, 6, 3)) > 0.3
    rpy = rng.uniform(-1, 1, (2, 3))
    t = rng.normal(size=(2, 3))
    pc = x + np.array([0.0, 0.0, 5.0])
    return {
        "norm": (lambda: tnorms.norm(T(x), dim=1), lambda: jnorms.norm(jnp.asarray(x), axis=1)),
        "rms": (lambda: tnorms.rms(T(x)), lambda: jnorms.rms(jnp.asarray(x))),
        "masked_rms": (lambda: tnorms.masked_rms(T(x), T(mask), dim=-1, eps=1e-12),
                       lambda: jnorms.masked_rms(jnp.asarray(x), jnp.asarray(mask), axis=-1,
                                                 eps=1e-12)),
        "append_col": (lambda: tnorms.append_col(T(x), 1.0),
                       lambda: jnorms.append_col(jnp.asarray(x), 1.0)),
        "perspective_divide": (lambda: tproj.perspective_divide(T(pc)),
                               lambda: jproj.perspective_divide(jnp.asarray(pc))),
        "rotate_translate": (lambda: trot.rotate_translate(T(x), T(rpy), T(t)),
                             lambda: jrot.rotate_translate(jnp.asarray(x), jnp.asarray(rpy),
                                                           jnp.asarray(t))),
    }


@pytest.mark.parametrize("name", ["norm", "rms", "masked_rms", "append_col",
                                  "perspective_divide", "rotate_translate"])
def test_small_helpers_match_jax(name):
    """norm, rms, masked_rms, append_col, perspective_divide and
    rotate_translate in f64 against the JAX package's: rounding only
    (masked-out entries and the broadcast translation included)."""
    port, jax_fn = _helper_cases()[name]
    got, want = port(), np.asarray(jax_fn())
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
