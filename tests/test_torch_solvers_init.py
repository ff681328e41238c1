"""The port's linear pose initializers, sigma clipping and spherical
conversions against the JAX package (CPU, f64, 1e-9), plus the exact-recovery
oracles of ``tests/test_solvers.py`` and the sigma-clipping oracle of
``tests/test_features.py`` on the port alone. Where an SVD's sign is free the
comparison is on ``H / H[2, 2]``, ``R`` and ``t``, never on singular vectors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_tpu.geometry import Intrinsics as JaxIntrinsics
from velocity_tpu.geometry import spherical as jax_spherical
from velocity_tpu.ops import sigma_rejection as jax_sigma_rejection
from velocity_tpu.solvers import linear_init as jax_init
from velocity_tpu_torch.geometry import spherical
from velocity_tpu_torch.geometry.plate import license_plate_points
from velocity_tpu_torch.geometry.projection import Intrinsics
from velocity_tpu_torch.geometry.rotations import rpy_to_matrix
from velocity_tpu_torch.ops import sigma_rejection
from velocity_tpu_torch.solvers import linear_init

torch.set_num_threads(1)

K = (1993.89, 1993.89, 960.5, 540.5, 0.0)
INTR = Intrinsics(*(torch.tensor(v, dtype=torch.float64) for v in K))
JINTR = JaxIntrinsics(*(jnp.float64(v) for v in K))


def _project_np(pc):
    return np.stack([K[0] * pc[:, 0] / pc[:, 2] + K[2], K[1] * pc[:, 1] / pc[:, 2] + K[3]],
                    axis=1)


def _dcm(rpy):
    return rpy_to_matrix(torch.as_tensor(rpy, dtype=torch.float64)).numpy()


def _plate_scene(rng, noise_px=0.0):
    """Plate corners + 8 more points of the plate plane, seen from a tilted
    pose 3.6 m away: (plane points (12, 3), pixels (12, 2), C, t)."""
    plate = np.asarray(license_plate_points("Chile"), np.float64)
    extra = np.concatenate([rng.uniform(-0.18, 0.18, (8, 1)), rng.uniform(-0.06, 0.06, (8, 1)),
                            np.zeros((8, 1))], axis=1)
    pts = np.concatenate([plate, extra])
    C = _dcm([0.4, 0.35, 0.25])
    t = np.array([1.5, 0.45, 3.6])
    p = _project_np(pts @ C + t) + rng.normal(0, noise_px, (len(pts), 2))
    return pts, p, C, t


@pytest.mark.parametrize("noise_px", [0.0, 0.5])
def test_dlt_homography_matches_jax(noise_px):
    pts, p, _, _ = _plate_scene(np.random.default_rng(3), noise_px)
    got = linear_init.dlt_homography(torch.as_tensor(pts[:, :2]), torch.as_tensor(p))
    want = np.asarray(jax_init.dlt_homography(jnp.asarray(pts[:, :2]), jnp.asarray(p)))
    assert got[2, 2] == 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
    ph = np.concatenate([pts[:, :2], np.ones((len(pts), 1))], 1) @ got.numpy().T
    assert np.abs(ph[:, :2] / ph[:, 2:] - p).max() < 1e-8 + 4 * noise_px


@pytest.mark.parametrize("noise_px", [0.0, 0.5])
def test_planar_pose_matches_jax(noise_px):
    pts, p, _, _ = _plate_scene(np.random.default_rng(4), noise_px)
    R, t = linear_init.planar_pose(INTR, torch.as_tensor(p), torch.as_tensor(pts))
    jR, jt = jax_init.planar_pose(JINTR, jnp.asarray(p), jnp.asarray(pts))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-9)


@pytest.mark.parametrize("noise_px", [0.0, 0.5])
def test_rotation_lsq_matches_jax(noise_px):
    rng = np.random.default_rng(5)
    C = _dcm([0.1, -0.2, 0.3])
    dirs = rng.normal(size=(30, 3))
    dirs[:, 2] = np.abs(dirs[:, 2]) + 2
    p = _project_np(dirs @ C) + rng.normal(0, noise_px, (30, 2))
    got = linear_init.rotation_lsq(INTR, torch.as_tensor(p), torch.as_tensor(dirs))
    want = jax_init.rotation_lsq(JINTR, jnp.asarray(p), jnp.asarray(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.numpy() @ got.numpy().T, np.eye(3), atol=1e-12)


class TestLinearInit:
    """planar_pose (extrinsicsPlanar parity) and rotation_lsq (fcnLS_R)."""

    def test_planar_pose_exact(self):
        pts, p, C, t_true = _plate_scene(np.random.default_rng(7))
        R, t = linear_init.planar_pose(INTR, torch.as_tensor(p), torch.as_tensor(pts))
        np.testing.assert_allclose(R.numpy(), C, atol=1e-10)
        np.testing.assert_allclose(t.numpy(), t_true, atol=1e-10)

    def test_rotation_lsq_exact(self):
        rng = np.random.default_rng(7)
        C = _dcm([0.1, -0.2, 0.3])
        dirs = rng.normal(size=(30, 3))
        dirs[:, 2] = np.abs(dirs[:, 2]) + 2
        R = linear_init.rotation_lsq(INTR, torch.as_tensor(_project_np(dirs @ C)),
                                     torch.as_tensor(dirs))
        np.testing.assert_allclose(R.numpy(), C, atol=1e-12)


@pytest.mark.parametrize("srl,iterations", [(3.0, 3), (2.0, 1), (2.5, 5)])
@pytest.mark.parametrize("masked", [False, True])
def test_sigma_rejection_matches_jax(srl, iterations, masked):
    """Equal surviving masks, with and without an input mask (f64 and f32)."""
    rng = np.random.default_rng(13)
    x = np.concatenate([rng.normal(0, 1, 500), [25.0, -31.0, 40.0, 6.0, -5.5]])
    mask = rng.uniform(size=x.shape) < 0.8 if masked else None
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        got = sigma_rejection(torch.as_tensor(x, dtype=dt),
                              None if mask is None else torch.as_tensor(mask),
                              srl=srl, iterations=iterations)
        want = jax_sigma_rejection(jnp.asarray(x, jdt),
                                   None if mask is None else jnp.asarray(mask),
                                   srl=srl, iterations=iterations)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.bool and 0 < int(got.sum()) < x.size


class TestRobust:
    def test_sigma_rejection_matches_reference_semantics(self):
        rng = np.random.default_rng(7)
        x = np.concatenate([rng.normal(0, 1, 500), np.array([25.0, -31.0, 40.0])])
        v = sigma_rejection(torch.as_tensor(x), srl=3.0, iterations=3).numpy()
        assert not v[-3:].any()
        assert v[:500].mean() > 0.97

        # numpy twin (the reference algorithm on compacted arrays)
        xx = x.copy()
        vv = np.ones_like(x, bool)
        for _ in range(3):
            s = xx.std() * 3.0
            mu = xx.mean()
            keep = (xx < mu + s) & (xx > mu - s)
            xx = xx[keep]
            vv[vv] = keep
        np.testing.assert_array_equal(v, vv)


def test_spherical_conversions_match_jax():
    """cartesian_to_spherical and spherical_to_cartesian against JAX (1e-12),
    batched over leading axes, and each other's inverse."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(4, 25, 3)) * 10
    s = spherical.cartesian_to_spherical(torch.as_tensor(x))
    np.testing.assert_allclose(s.numpy(),
                               np.asarray(jax_spherical.cartesian_to_spherical(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    back = spherical.spherical_to_cartesian(s)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jax_spherical.spherical_to_cartesian(jnp.asarray(s.numpy()))),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-12)
    # +X north, +Z down: a point straight up has elevation +90 degrees
    up = spherical.cartesian_to_spherical(torch.tensor([0.0, 0.0, -2.0], dtype=torch.float64))
    np.testing.assert_allclose(up.numpy(), [2.0, np.pi / 2, 0.0], atol=1e-12)
