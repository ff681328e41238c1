"""Bundle adjustment: free-pose and constrained variants (torch twin of
``velocity_tpu/solvers/ba.py``).

- ``ba_dense``: the reference's ``fcnNLS_batch``. Parameters are
  [point xyz (nt, 3); camera pos+rpy (nc-1, 6)], camera 0 pinned at identity,
  identity damping, step scale 0.9, <= 10 iterations, converged when
  rms(delta) < tol. The dense Jacobian comes from forward-mode
  differentiation of the residual (``torch.func.jacfwd``).
- ``ba_constrained``: the reference's ``fcnNLS_batch2``, the straight-line
  motion prior: one shared rpy, one el/az direction, per-camera ranges.
- ``ba_schur`` (``solvers/schur.py``): the block-sparse formulation with the
  Schur-complement camera reduction, same optimum.

Observations are a dense (nc, nt) grid with a validity mask: every surviving
track is visible in all frames of a window, and masked lanes are inert. The
Gauss-Newton loops run on the host; their convergence test is the one
device-to-host read per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from velocity_tpu_torch.config import BAConfig
from velocity_tpu_torch.geometry.projection import Intrinsics, project_camera_points
from velocity_tpu_torch.geometry.rotations import rpy_to_matrix
from velocity_tpu_torch.geometry.spherical import (
    cam_to_ned_matrix, cartesian_to_spherical, spherical_to_cartesian)


class BAProblem(NamedTuple):
    intr: Intrinsics
    pixels: torch.Tensor  # (nc, nt, 2) observations
    mask: torch.Tensor  # (nc, nt) bool validity
    points0: torch.Tensor  # (nt, 3) initial world points (camera-0 frame)
    cams0: torch.Tensor  # (nc, 6) initial [pos(3), rpy(3)]; camera 0 stays fixed


class BAResult(NamedTuple):
    points: torch.Tensor  # (nt, 3)
    cams: torch.Tensor  # (nc, 6)
    iterations: int
    residual_rms: torch.Tensor  # masked rms reprojection error (pixels)


def _project_all(intr, points, cams):
    """(nc, nt, 2) projections of all points into all cameras (camera 0 = identity)."""
    C = rpy_to_matrix(cams[:, 3:6])  # (nc, 3, 3)
    pc = torch.einsum("ti,cij->ctj", points, C) + cams[:, None, 0:3]
    return project_camera_points(intr, pc)


def _masked_residual_px(intr, problem, points, cams):
    zhat = _project_all(intr, points, cams)
    return torch.where(problem.mask[..., None], problem.pixels - zhat, 0.0)


def ba_residual_rms(problem: BAProblem, points, cams):
    r = _masked_residual_px(problem.intr, problem, points, cams)
    n = torch.clamp(2.0 * torch.sum(problem.mask), min=1.0)
    return torch.sqrt(torch.sum(r * r) / n)


def step_tolerance(config: BAConfig, dtype) -> float:
    """The rms(delta) below which a BA loop stops: ``config.tol``, but never
    under 50 machine epsilons of the working dtype."""
    return max(config.tol, 50.0 * torch.finfo(dtype).eps)


def _gauss_newton(residual, x0, damping_eye, config: BAConfig, max_iters: int):
    """Damped Gauss-Newton on the dense Jacobian of ``residual``: iterate
    while ``i < max_iters`` and ``rms(delta) >= tol``. Returns (x, iterations)."""
    tol = step_tolerance(config, x0.dtype)
    jac = torch.func.jacfwd(residual)
    x, i, d = x0, 0, float("inf")
    while i < max_iters and d >= tol:
        r = residual(x)
        J = jac(x)
        delta = torch.linalg.solve(J.T @ J + damping_eye, -(J.T @ r)) * config.step_scale
        x = x + delta
        i += 1
        d = float(torch.sqrt(torch.mean(delta * delta)))
    return x, i


def ba_dense(problem: BAProblem, config: BAConfig = BAConfig()) -> BAResult:
    """Dense-Jacobian BA, the reference-parity twin (small problems and tests)."""
    intr = problem.intr
    nt = problem.points0.shape[0]
    nc = problem.cams0.shape[0]
    dtype, dev = problem.points0.dtype, problem.points0.device
    inv_f = 1.0 / intr.fx
    nx = nt * 3 + (nc - 1) * 6

    def unpack(x):
        points = x[: nt * 3].reshape(nt, 3)
        cams_free = x[nt * 3:].reshape(nc - 1, 6)
        cams = torch.cat([torch.zeros((1, 6), dtype=dtype, device=dev), cams_free], dim=0)
        return points, cams

    def residual(x):
        points, cams = unpack(x)
        r = _masked_residual_px(intr, problem, points, cams)
        return (r * inv_f).reshape(-1)

    x0 = torch.cat([problem.points0.reshape(-1), problem.cams0[1:].reshape(-1)]).to(dtype)
    eye = torch.eye(nx, dtype=dtype, device=dev) * (config.damping * inv_f * inv_f)
    x, iters = _gauss_newton(residual, x0, eye, config, config.max_iters)
    points, cams = unpack(x)
    return BAResult(points=points, cams=cams, iterations=iters,
                    residual_rms=ba_residual_rms(problem, points, cams))


def ba_constrained(problem: BAProblem, config: BAConfig = BAConfig()) -> BAResult:
    """Straight-line-motion-prior BA (the reference's ``fcnNLS_batch2``).

    Parameters: [point xyz; shared camera rpy (3); el; az; per-camera ranges
    (nc-1)]: cameras constrained to a line through camera 0 with direction
    (el, az) in NED, at per-camera ranges.
    """
    intr = problem.intr
    nt = problem.points0.shape[0]
    nc = problem.cams0.shape[0]
    dtype, dev = problem.points0.dtype, problem.points0.device
    inv_f = 1.0 / intr.fx
    Cn = cam_to_ned_matrix(dtype, dev)

    # init el/az/ranges from the initial camera track
    d1 = (problem.cams0[1, 0:3] - problem.cams0[0, 0:3]) @ Cn.T
    sc = cartesian_to_spherical(d1)
    ranges0 = torch.arange(1, nc, dtype=dtype, device=dev) * sc[0]
    x0 = torch.cat([problem.points0.reshape(-1), torch.zeros(3, dtype=dtype, device=dev),
                    sc[1:3], ranges0])
    nx = x0.shape[0]

    def unpack(x):
        j = nt * 3
        points = x[:j].reshape(nt, 3)
        rpy = x[j: j + 3]
        el, az = x[j + 3], x[j + 4]
        ranges = x[j + 5:]
        sph = torch.stack([ranges, el.expand_as(ranges), az.expand_as(ranges)], dim=1)
        offsets = spherical_to_cartesian(sph) @ Cn  # NED -> camera frame
        pos = torch.cat([torch.zeros((1, 3), dtype=dtype, device=dev), offsets], dim=0)
        rpys = torch.cat([torch.zeros((1, 3), dtype=dtype, device=dev),
                          rpy.expand(nc - 1, 3)], dim=0)
        return points, torch.cat([pos, rpys], dim=1)

    def residual(x):
        points, cams = unpack(x)
        # the reference applies the shared rotation to the points, camera 0's
        # view included: pc = pw @ R, then the per-camera offset
        R = rpy_to_matrix(x[nt * 3: nt * 3 + 3])
        pr = points @ R
        pc = pr[None, :, :] + cams[:, None, 0:3]
        zhat = project_camera_points(intr, pc)
        r = torch.where(problem.mask[..., None], problem.pixels - zhat, 0.0)
        return (r * inv_f).reshape(-1)

    eye = torch.eye(nx, dtype=dtype, device=dev) * (config.damping * inv_f * inv_f)
    # the reference runs this variant for 20 iterations
    x, iters = _gauss_newton(residual, x0, eye, config, config.max_iters * 2)
    points, cams = unpack(x)
    # Fold the shared rotation into the points (rotation gauge): the model is
    # zhat_c = project(points @ R + pos_c) for every camera including 0, which
    # equals the camera-0-identity convention on points' = points @ R.
    R = rpy_to_matrix(x[nt * 3: nt * 3 + 3])
    points = points @ R
    cams = torch.cat([cams[:, 0:3], torch.zeros_like(cams[:, 3:6])], dim=1)
    return BAResult(points=points, cams=cams, iterations=iters,
                    residual_rms=ba_residual_rms(problem, points, cams))
