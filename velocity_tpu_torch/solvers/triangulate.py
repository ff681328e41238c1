"""Multi-view triangulation (MSV) and the newest-camera Gauss-Newton refine.

Torch twin of ``velocity_tpu/solvers/triangulate.py`` (the reference's
``fcn2vintercept``, ``fcnNvintercept`` and ``fcnMSV1_t``). Ray layout is
(nf, N, 3): frames leading, points next.
``nray_intercept_masked_np`` is the host numpy twin, copied as it is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from velocity_tpu_torch.config import SolverConfig
from velocity_tpu_torch.geometry.projection import (
    Intrinsics,
    pixel_to_unit_ray,
    project_camera_points,
)
from velocity_tpu_torch.solvers.lm import lm_solve


def _pair_indices(nf: int, device=None):
    """Upper-triangle pair index arrays (j < k) for nf frames."""
    j, k = np.triu_indices(nf, k=1)
    return torch.as_tensor(j, device=device), torch.as_tensor(k, device=device)


def pairwise_intercept(origins: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """Average two-ray nearest-point midpoints over all frame pairs.

    origins (nf, 3), rays (nf, N, 3) unit -> (N, 3) points.
    """
    nf = rays.shape[0]
    jdx, kdx = _pair_indices(nf, rays.device)

    u = rays[jdx]  # (npair, N, 3)
    v = rays[kdx]
    dA = (origins[jdx] - origins[kdx])[:, None, :]  # (npair, 1, 3)

    d = torch.sum(u * v, dim=-1)  # (npair, N)
    e = torch.sum(u * dA, dim=-1)
    f = torch.sum(v * dA, dim=-1)
    g = 1.0 - d * d
    s1 = (d * f - e) / g  # along u
    t1 = (f - d * e) / g  # along v

    # the origin terms of the midpoints collapse to sum(origins) * (nf - 1)
    npair = jdx.shape[0]
    B = torch.sum(origins, dim=0) * (nf - 1)
    uv = t1[..., None] * v + s1[..., None] * u
    return (torch.sum(uv, dim=0) + B) / (2.0 * npair)


def pairwise_intercept_affine(fixed: torch.Tensor, rays: torch.Tensor):
    """``pairwise_intercept`` as an affine map of the last origin.

    fixed (nf-1, 3) origins of all frames but the last, rays (nf, N, 3)
    unit -> (C (N, 3), M (N, 3, 3)) with
    ``pairwise_intercept(cat([fixed, a]), rays) = C + M @ a``: the midpoints
    are linear in the origins and only the pairs (j, nf-1) hold ``a``
    (d e/da = -u, d f/da = -v, so d s1/da = (u - d v)/g and
    d t1/da = (d u - v)/g), and the origin term adds (nf-1) I.
    """
    nf = rays.shape[0]
    C = pairwise_intercept(torch.cat([fixed, fixed.new_zeros(1, 3)]), rays)
    u, v = rays[:-1], rays[-1:]  # the pairs (j, nf-1)
    d = torch.sum(u * v, dim=-1)[..., None]  # (nf-1, N, 1)
    g = (1.0 - d * d)[..., None]
    duv = v[..., :, None] * (d * u - v)[..., None, :] + u[..., :, None] * (u - d * v)[..., None, :]
    eye = torch.eye(3, dtype=rays.dtype, device=rays.device)
    M = (torch.sum(duv / g, dim=0) + (nf - 1) * eye) / float(nf * (nf - 1))
    return C, M


def nray_intercept(origins: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """Least-squares intersection of the rays per point via 3x3 normal equations."""
    eye = torch.eye(3, dtype=rays.dtype, device=rays.device)
    P = eye - rays[..., :, None] * rays[..., None, :]  # (nf, N, 3, 3)
    S1 = torch.sum(P, dim=0)
    S2 = torch.einsum("fnij,fj->ni", P, origins)
    return torch.linalg.solve(S1, S2[..., None])[..., 0]


def nray_intercept_masked_np(intr_np, track_px, tvecs, mask,
                             min_obs: int = 2, max_residual_px: float = 3.0,
                             depth_range=None):
    """Host-side masked N-ray triangulation for lanes with PARTIAL histories.

    Replenished lanes enter mid-sequence, so unlike ``nray_intercept`` each
    lane uses only the frames where it was observed. The motion model is the
    pipeline's post-frame-0 convention (R = I, p_cam = p3 + t_f, reference
    vidExample.py:120): pixel (u, v) in frame f rays along
    d = [(u-cx)/fx, (v-cy)/fy, 1] from origin -t_f.

    Acceptance gates — a lane is ``ok`` only when its triangulation carries
    usable pose information:
      * >= ``min_obs`` observations, finite solution, positive depth at every
        observed frame;
      * reprojection rms over its own history <= ``max_residual_px`` — a
        WORLD-static lane (background) has parallel-but-offset rays in the
        car frame whose least-squares point reprojects inconsistently, so
        this gate rejects the lanes that would otherwise drag the pose solve
        toward zero motion;
      * optional ``depth_range=(zmin, zmax)``: last-frame camera depth must
        be plausible (callers pass a band around the live structure's median
        depth — catches depth-ambiguous near-coincident ray bundles that
        happen to reproject consistently).

    Args:
      intr_np: (fx, fy, cx, cy) floats.
      track_px: (k, N, 2) pixels (NaN where unobserved).
      tvecs: (k, 3) per-frame camera translations t_f.
      mask: (k, N) observation validity.

    Returns:
      (p3 (N, 3), ok (N,)).
    """
    import numpy as np

    fx, fy, cx, cy = intr_np
    k, N, _ = track_px.shape
    m = mask & np.isfinite(track_px).all(axis=2)
    t = np.nan_to_num(track_px.astype(np.float64))
    rays = np.stack(
        [(t[..., 0] - cx) / fx, (t[..., 1] - cy) / fy, np.ones((k, N))],
        axis=-1,
    )
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    tvecs = np.asarray(tvecs, np.float64)
    origins = -tvecs  # (k, 3)
    eye = np.eye(3)
    P = (eye - rays[..., :, None] * rays[..., None, :]) * m[..., None, None]
    S1 = P.sum(axis=0)  # (N, 3, 3)
    S2 = np.einsum("fnij,fj->ni", P, origins)
    nobs = np.maximum(m.sum(axis=0), 1)
    p3 = np.linalg.solve(S1 + eye * 1e-9, S2[..., None])[..., 0]

    # per-lane reprojection rms over the observed frames
    pc = p3[None, :, :] + tvecs[:, None, :]  # (k, N, 3)
    z = pc[..., 2]
    z_safe = np.where(np.abs(z) > 1e-9, z, 1e-9)
    u = fx * pc[..., 0] / z_safe + cx
    v = fy * pc[..., 1] / z_safe + cy
    err2 = (u - t[..., 0]) ** 2 + (v - t[..., 1]) ** 2
    rms = np.sqrt(np.where(m, err2, 0.0).sum(axis=0) / nobs)
    depth_ok = np.where(m, z > 1e-2, True).all(axis=0)

    ok = (
        (m.sum(axis=0) >= min_obs)
        & np.isfinite(p3).all(axis=1)
        & depth_ok
        & (rms <= max_residual_px)
    )
    if depth_range is not None:
        z_last = p3[:, 2] + tvecs[-1][2]
        ok &= (z_last >= depth_range[0]) & (z_last <= depth_range[1])
    return p3, ok


class MSVResult(NamedTuple):
    t: torch.Tensor  # (3,) refined translation of the newest camera
    points: torch.Tensor  # (N, 3) triangulated cloud at the solution
    iterations: int
    residual_rms: torch.Tensor
    rejected: int = 0  # LM trial steps refused (config.msv_solve "tracked")


def msv_refine_translation(
    intr: Intrinsics,
    pixels: torch.Tensor,  # (nf, N, 2) tracked pixels for frames 0..nf-1
    mask: torch.Tensor,  # (N,) bool validity (tracks alive in all nf frames)
    origins: torch.Tensor,  # (nf, 3) camera positions (camera-0 frame)
    config: SolverConfig = SolverConfig(),
    x0: torch.Tensor | None = None,
    use_nray: bool = False,
) -> MSVResult:
    """Gauss-Newton refinement of the newest camera translation (fcnMSV1_t).

    The residual projects the re-triangulated cloud into the newest camera,
    so moving x moves that camera and every intercept. Masked lanes are
    sanitized (pixels -> principal point) and excluded from the residual.

    ``config.msv_solve`` picks the start and the steps. "upstream" starts 1 m
    beyond the previous camera and takes every damped step, as
    ``MSV.py:8-42`` does. "tracked" starts at the newest camera's own
    tracked translation, ``origins[-1] - origins[0]``, and keeps a step only
    where the cost fell (``lm_solve(accept_steps=True)``): the objective is
    not convex (a track whose rays are nearly parallel, near the point the
    car recedes from, has an intercept that swings metres as x moves), and
    from upstream's start the solve can settle in, or cycle around, a basin
    far from the minimum that fits every track.
    """
    if config.msv_solve not in ("upstream", "tracked"):
        raise ValueError(f"msv_solve is 'upstream' or 'tracked', not {config.msv_solve!r}")
    tracked = config.msv_solve == "tracked"
    dtype = pixels.dtype
    nf = pixels.shape[0]

    safe = torch.stack([torch.ones(pixels.shape[:-1], dtype=dtype) * intr.cx,
                        torch.ones(pixels.shape[:-1], dtype=dtype) * intr.cy], dim=-1)
    m = mask[None, :, None]
    pix = torch.where(m, pixels, safe.to(pixels.device))

    rays = pixel_to_unit_ray(intr, pix)  # (nf, N, 3)
    u0 = origins[0][None, :] - origins  # (nf, 3)
    if x0 is None:
        x0 = -u0[nf - 1] if tracked else (
            torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=pixels.device) - u0[nf - 2])

    z = pix[nf - 1]  # (N, 2) observations in the newest frame
    mz = mask[:, None]
    intercept = nray_intercept if use_nray else pairwise_intercept
    inv_f = 1.0 / intr.fx

    closed = {}
    if tracked and not use_nray:
        # the cloud in the newest-camera frame is C + K x (the last origin
        # is -x): the residual and its Jacobian in closed form, a few host
        # ops a call where the forward-mode pass takes hundreds
        C, M = pairwise_intercept_affine(u0[:-1], rays)
        K = torch.eye(3, dtype=dtype, device=pixels.device) - M
        mj = mz[..., None]
        fx, fy, skew = intr.fx, intr.fy, intr.skew

        def cloud_at(x):
            return C + K @ x

        def jacobian(x):
            X, Y, Z = cloud_at(x).unbind(-1)
            iz = 1.0 / Z
            zero = torch.zeros_like(iz)
            dproj = torch.stack([  # d zhat / d cloud, (N, 2, 3)
                torch.stack([fx * iz, skew * iz, -(fx * X + skew * Y) * iz * iz], -1),
                torch.stack([zero, fy * iz, -fy * Y * iz * iz], -1)], -2)
            return (torch.where(mj, -(dproj @ K), 0.0) * inv_f).reshape(-1, 3)

        closed["jacobian_fn"] = jacobian
    else:
        def cloud_at(x):
            A = torch.cat([u0[:-1], -x[None, :]], dim=0)  # (nf, 3)
            return intercept(A, rays) + x  # into the newest-camera frame

    def residual(x):
        zhat = project_camera_points(intr, cloud_at(x))
        # where, not multiply: masked lanes can triangulate to inf/nan
        return (torch.where(mz, z - zhat, 0.0) * inv_f).reshape(-1)

    res = lm_solve(
        residual,
        x0.to(dtype),
        max_iters=config.max_iters_msv,
        damping=config.damping * inv_f * inv_f,
        tol=config.tol,
        use_ramp=False,
        num_residuals=2.0 * torch.sum(mask),
        accept_steps=tracked,
        **closed,
    )

    A = torch.cat([u0[:-1], -res.x[None, :]], dim=0)
    cloud = intercept(A, rays) + res.x
    return MSVResult(t=res.x, points=cloud, iterations=res.iterations,
                     residual_rms=res.residual_rms, rejected=res.rejected)
