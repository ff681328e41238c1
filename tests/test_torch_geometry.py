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
