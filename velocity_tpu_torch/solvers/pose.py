"""Camera pose solvers: plate-anchored LM with masked static shapes.

Torch twin of ``velocity_tpu/solvers/pose.py``:
- ``solve_translation``  <-> reference ``fcnNLS_t``
- ``solve_pose_rt``      <-> reference ``fcnNLS_Rt``
- ``estimate_world_camera_pose`` <-> reference ``estimateWorldCameraPose``
The host numpy twins (``_planar_pose_homography_np``, ``_polish_pose_np``,
``solve_translation_np``, ``_mirror_plate_pose_np``) are copied as they are,
but that ``_polish_pose_np`` and ``solve_translation_np`` project the base
and the forward-difference poses of an iteration in one call: the same
arithmetic element for element, so the same bits.

Lanes (JAX's vmap over videos): ``solve_translation`` and
``estimate_world_camera_pose(find_R=False)`` take points with a leading
lane axis, (V, N, 2) and (V, N, 3), translations (V, 3), masks (V, N) and
``Intrinsics.stack``-ed cameras; each lane's LM stops on its own (see
``solvers/lm.py``), and its robust second pass decides on its own points.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from velocity_tpu_torch.config import SolverConfig
from velocity_tpu_torch.geometry.projection import (
    Intrinsics,
    project_camera_points,
    world_to_image,
)
from velocity_tpu_torch.geometry.rotations import matrix_to_rpy, rpy_to_matrix
from velocity_tpu_torch.solvers.lm import LMResult, lm_solve


class PoseResult(NamedTuple):
    t: torch.Tensor  # (3,) camera->plate translation (camera frame); (V, 3) with lanes
    R: torch.Tensor  # (3, 3) rotation (row-vector convention)
    residual_rms: torch.Tensor  # masked rms reprojection error (px)
    p_proj: torch.Tensor  # (N, 2) reprojected points (all lanes)
    iterations: int  # a list, one per lane, with lanes


def _masked_residual(intr, p, mask, predict):
    """r = where(mask, (p - predict(x))/fx, 0) flattened, the valid count and
    the matching damping scale. Normalized units keep J^T J O(1) in f32; with
    the damping scaled by 1/fx^2 the iterates equal the pixel-unit ones."""
    m = mask[..., None]
    inv_f = 1.0 / intr.fx
    inv_f_p = inv_f if inv_f.dim() == 0 else inv_f[:, None, None]  # per lane

    def residual(x):
        return (torch.where(m, p - predict(x), 0.0) * inv_f_p).reshape(p.shape[:-2] + (-1,))

    nvalid = 2.0 * torch.sum(mask, dim=-1)
    damping_scale = inv_f * inv_f
    return residual, nvalid, damping_scale


def solve_translation(
    intr: Intrinsics,
    p: torch.Tensor,  # (N, 2) observed pixels
    pw: torch.Tensor,  # (N, 3) world points (camera-frame, R folded in by caller)
    t0: torch.Tensor,  # (3,) initial translation
    mask: torch.Tensor | None = None,  # (N,) bool validity
    config: SolverConfig = SolverConfig(),
) -> LMResult:
    """3-parameter LM: find t minimizing ||p - project(pw + t)|| over valid
    points (per lane, where the inputs have a lane axis)."""
    if mask is None:
        mask = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
    residual, nvalid, dscale = _masked_residual(
        intr, p, mask, lambda x: project_camera_points(intr, pw + x.unsqueeze(-2))
    )
    return lm_solve(
        residual,
        t0,
        max_iters=config.max_iters_pose,
        damping=config.damping * dscale,
        tol=config.tol,
        ramp_rate=config.ramp_rate,
        num_residuals=nvalid,
    )


def solve_pose_rt(
    intr: Intrinsics,
    p: torch.Tensor,  # (N, 2)
    pw: torch.Tensor,  # (N, 3)
    x0: torch.Tensor,  # (6,) [rpy, t]
    mask: torch.Tensor | None = None,
    config: SolverConfig = SolverConfig(),
) -> LMResult:
    """6-parameter LM over [roll, pitch, yaw, tx, ty, tz]."""
    if mask is None:
        mask = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
    residual, nvalid, dscale = _masked_residual(
        intr,
        p,
        mask,
        lambda x: project_camera_points(intr, pw @ rpy_to_matrix(x[:3]) + x[3:6]),
    )
    return lm_solve(
        residual,
        x0,
        max_iters=config.max_iters_pose,
        damping=config.damping * dscale,
        tol=config.tol,
        ramp_rate=config.ramp_rate,
        num_residuals=nvalid,
    )


def _planar_pose_homography_np(intr: Intrinsics, q, plate):
    """Closed-form planar pose: DLT homography + orthogonalization (numpy).

    Row-vector convention throughout: s*[u,v,1] = [X,Y,1] @ G with
    G = [R[0]; R[1]; t] @ K_row. Deterministic (no iterative solver), which
    matters: the 6-DoF LM's basin choice on a noisy 4-corner quad varies with
    ULP-level differences across processes/compiles.
    """
    import numpy as np

    q = np.asarray(q, np.float64)
    P = np.asarray(plate, np.float64)
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        X, Y = P[i, 0], P[i, 1]
        u, v = q[i]
        # [X,Y,1]@G ~ s[u,v,1], G[2,2]=1:
        A[2 * i] = [X, Y, 1, 0, 0, 0, -u * X, -u * Y]
        b[2 * i] = u
        A[2 * i + 1] = [0, 0, 0, X, Y, 1, -v * X, -v * Y]
        b[2 * i + 1] = v
    g = np.linalg.solve(A, b)
    G = np.array([[g[0], g[3], g[6]], [g[1], g[4], g[7]], [g[2], g[5], 1.0]])
    fx, fy = float(intr.fx), float(intr.fy)
    cx, cy = float(intr.cx), float(intr.cy)
    sk = float(intr.skew)
    K_row = np.array([[fx, 0, 0], [sk, fy, 0], [cx, cy, 1.0]])
    M = G @ np.linalg.inv(K_row)
    lam = 0.5 * (np.linalg.norm(M[0]) + np.linalg.norm(M[1]))
    M = M / lam
    if M[2, 2] < 0:  # plate must be in front of the camera
        M = -M
    r0, r1 = M[0], M[1]
    R_raw = np.stack([r0, r1, np.cross(r0, r1)])
    U, _S, Vt = np.linalg.svd(R_raw)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
    return R, M[2]


def _polish_pose_np(intr: Intrinsics, q, plate, R0, t0,
                    iters: int = 60, clamp: float = 0.05):
    """Deterministic damped Gauss-Newton polish of a planar pose (numpy).

    Small clamped steps keep the iterate INSIDE its seed's basin — the
    planar-ambiguity branches are ~30 deg apart, so a 0.05 rad/m per-step
    clamp cannot hop between them. Pure float64 numpy: identical results in
    every process (the jitted LM's basin choice was observed to vary with
    which cached executable serves the solve).
    """
    import numpy as np

    fx, fy = float(intr.fx), float(intr.fy)
    cx, cy = float(intr.cx), float(intr.cy)
    sk = float(intr.skew)
    P = np.asarray(plate, np.float64)
    qn = np.asarray(q, np.float64)

    def project(pc):  # (..., 4, 3) camera-frame corners -> (..., 4, 2)
        u = (fx * pc[..., 0] + sk * pc[..., 1]) / pc[..., 2] + cx
        v = fy * pc[..., 1] / pc[..., 2] + cy
        return np.stack([u, v], -1)

    def rot(w):
        th = np.linalg.norm(w)
        if th < 1e-12:
            return np.eye(3)
        a = w / th
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)

    R, t = np.asarray(R0, np.float64).copy(), np.asarray(t0, np.float64).copy()
    eps = 1e-6
    # the forward differences' rotations, and the base and translated poses'
    # offsets, are the same every iteration: the 7 projections of an
    # iteration are one call on a (7, 4, 3) stack, element for element the
    # arithmetic of 7 calls
    rots = [rot(w) for w in np.eye(3) * eps]
    shifts = np.concatenate([np.zeros((1, 3)), np.eye(3) * eps])  # base, t + dt_k
    for _ in range(iters):
        PR = P @ R
        pcs = np.concatenate([[P @ (R @ d.T) + t for d in rots], PR + (t + shifts)[:, None, :]])
        rs = (qn - project(pcs)).reshape(7, 8)
        r0 = rs[3]
        J = np.ascontiguousarray(((rs[[0, 1, 2, 4, 5, 6]] - r0) / eps).T)
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
    # re-orthonormalize (rot composition drift)
    U, _s, Vt = np.linalg.svd(R)
    R = U @ Vt
    return R, t


def solve_translation_np(intr: Intrinsics, pix, p3, t0, mask,
                         max_iters: int = 30, damping: float = 1.0,
                         tol: float = 1e-8, ramp_rate: float = 0.2):
    """Pure-numpy twin of ``solve_translation`` (reference fcnNLS_t,
    NLS.py:102-129): forward-difference Jacobian (dx=1e-6), identity
    Marquardt damping, iteration-ramped step, rms(delta) convergence.

    Host-side and trace-free: the disambiguation scoring calls this ~10
    times per video, and the jitted solver's per-call retrace (closure
    residuals) cost >1 s of host time at the MSV anchor.
    """
    import numpy as np

    fx, fy = float(intr.fx), float(intr.fy)
    cx, cy = float(intr.cx), float(intr.cy)
    sk = float(intr.skew)
    P = np.asarray(p3, np.float64)[mask]
    z = np.asarray(pix, np.float64)[mask].ravel()
    x = np.asarray(t0, np.float64).copy()
    inv_f = 1.0 / fx

    def zhat(t):  # (..., 3) translations -> (..., 2M) pixels
        pc = P + t[..., None, :]
        u = (fx * pc[..., 0] + sk * pc[..., 1]) / pc[..., 2] + cx
        v = fy * pc[..., 1] / pc[..., 2] + cy
        return np.stack([u, v], -1).reshape(*t.shape[:-1], 2 * P.shape[0])

    dx = 1e-6
    lam = damping * inv_f * inv_f
    # the base and the 3 forward-difference translations in one call
    shifts = np.concatenate([np.zeros((1, 3)), np.eye(3) * dx])
    for i in range(max_iters):
        rs = (z - zhat(x + shifts)) * inv_f
        r = rs[0]
        J = np.ascontiguousarray(((rs[1:] - r) / dx).T)
        JTJ = J.T @ J + np.eye(3) * lam
        # J here is d(z - zhat)/dx = -d(zhat)/dx, so this step equals the
        # reference's +inv(JTJ) J_zhat^T (z - zhat) update (NLS.py:122)
        step = np.linalg.solve(JTJ, J.T @ r)
        scale = min(((i + 1) * ramp_rate) ** 2, 1.0)
        x = x - step * scale
        if np.sqrt(np.mean(step * step)) * scale < tol:
            break
    res = (z - zhat(x))
    rms = np.sqrt(np.mean(res * res)) if res.size else 0.0
    return x, rms


def _mirror_plate_pose_np(R, t):
    """The second branch of the planar two-fold ambiguity: reflect the plate
    normal across the center viewing ray (numpy row-vector R)."""
    import numpy as np

    n1 = R[2]
    v = t / max(np.linalg.norm(t), 1e-12)
    n2 = 2.0 * np.dot(n1, v) * v - n1
    axis = np.cross(n1, n2)
    s = np.linalg.norm(axis)
    if s < 1e-9:
        return None
    axis = axis / s
    cth = np.clip(np.dot(n1, n2), -1.0, 1.0)
    th = np.arccos(cth)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    Rot = np.eye(3) + np.sin(th) * K + (1 - cth) * (K @ K)
    return R @ Rot.T  # rows transform as r' = r @ Rot.T  (Rot @ n1 = n2)


def plate_pose_candidates(
    intr: Intrinsics,
    q: torch.Tensor,  # (4, 2) plate corner pixels
    plate: torch.Tensor,  # (4, 3) metric plate corners
    config: SolverConfig = SolverConfig(),
    min_sep_deg: float = 2.0,
):
    """Candidate interpretations of the 4-point planar plate pose.

    A noisy planar quad admits two perspective interpretations; both raw
    branches (closed-form homography and its mirror) and numpy polishes of
    them and of five tilted seeds are kept, deduplicated by angle, so the
    caller's track-consistency scoring (pipeline/anchor.py) sees both.
    Returns a list of PoseResult sorted by 4-corner residual (best first).
    """
    import numpy as np

    found = []

    def add(R, t):
        R = torch.as_tensor(R, dtype=q.dtype)
        t = torch.as_tensor(t, dtype=q.dtype)
        if float(t[2]) <= 0 or not np.isfinite(t.numpy()).all():
            return
        p_proj = world_to_image(intr, R, t, plate)
        err = q - p_proj
        rms = torch.sqrt(torch.sum(err * err) / (2.0 * q.shape[0]))
        cand = PoseResult(t=t, R=R, residual_rms=rms, p_proj=p_proj, iterations=0)
        for ci, c in enumerate(found):
            cosang = (np.trace(c.R.numpy() @ R.numpy().T) - 1.0) / 2.0
            ang = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
            if ang < min_sep_deg:
                if float(rms) < float(c.residual_rms):
                    found[ci] = cand
                return
        found.append(cand)

    def polish(R0, t0):
        Rp, tp = _polish_pose_np(intr, q.numpy().astype(np.float64),
                                 plate.numpy().astype(np.float64),
                                 np.asarray(R0, np.float64),
                                 np.asarray(t0, np.float64))
        add(Rp, tp)

    try:
        Rh, th = _planar_pose_homography_np(intr, q.numpy(), plate.numpy())
    except np.linalg.LinAlgError:
        Rh = None
    if Rh is not None:
        polish(Rh, th)
        Rm = _mirror_plate_pose_np(Rh, th)
        if Rm is not None:
            polish(Rm, th)

    def _tilt(rx, ry):
        cx_, sx = np.cos(rx), np.sin(rx)
        cy_, sy = np.cos(ry), np.sin(ry)
        Rx = np.array([[1, 0, 0], [0, cx_, sx], [0, -sx, cx_]])
        Ry = np.array([[cy_, 0, -sy], [0, 1, 0], [sy, 0, cy_]])
        return Rx @ Ry

    for (rx, ry) in [(0.0, 0.0), (0.6, 0.0), (-0.6, 0.0), (0.0, 0.6),
                     (0.0, -0.6)]:
        polish(_tilt(rx, ry), np.array([0.0, 0.0, 1.0]))

    found.sort(key=lambda c: float(c.residual_rms))
    return found


def unit_z(dtype, device):
    """(0, 0, 1), the pose solves' default start, made on ``device`` without
    a host-to-device copy."""
    return torch.eye(3, dtype=dtype, device=device)[2]


def _norm_rows(d):
    return torch.sqrt(torch.sum(d * d, dim=-1))


def estimate_world_camera_pose(
    intr: Intrinsics,
    p: torch.Tensor,  # (N, 2)
    p3: torch.Tensor,  # (N, 3) world points
    t0: torch.Tensor | None = None,
    R0: torch.Tensor | None = None,
    find_R: bool = False,
    mask: torch.Tensor | None = None,
    config: SolverConfig = SolverConfig(),
) -> PoseResult:
    """Full pose estimation entry point (reference estimateWorldCameraPose).

    find_R=True: 6-DoF solve from x0=[dcm2rpy(R0), t0]. find_R=False: hold R0,
    solve the translation of ``p3``, with the robust second pass of the JAX
    twin (reject > sigma*rms outliers only when the first pass is bad); it
    alone takes lanes (``p`` (V, N, 2), one R0 for all).
    """
    dtype = p.dtype
    dev = p.device
    lead = p.shape[:-2]
    if t0 is None:
        t0 = unit_z(dtype, dev).expand(lead + (3,))
    if R0 is None:
        R0 = torch.eye(3, dtype=dtype, device=dev)
    if mask is None:
        mask = torch.ones(p.shape[:-1], dtype=torch.bool, device=dev)
    if find_R and lead:
        raise ValueError("estimate_world_camera_pose: lanes take find_R=False only")

    if find_R:
        x0 = torch.cat([matrix_to_rpy(R0), t0])
        res = solve_pose_rt(intr, p, p3, x0, mask, config)
        R = rpy_to_matrix(res.x[:3]).to(dtype)
        t = res.x[3:6].to(dtype)
    else:
        res = solve_translation(intr, p, p3, t0, mask, config)
        R = R0
        if config.pose_reject_sigma > 0 and config.pose_reject_above_px > 0:
            proj1 = world_to_image(intr, R.to(dtype), res.x.to(dtype), p3)
            err1 = torch.where(mask, _norm_rows(p - proj1), 0.0)
            nv1 = torch.clamp(torch.sum(mask, dim=-1), min=1)
            rms1 = (torch.sqrt(torch.sum(err1 * err1, dim=-1) / nv1))[..., None]
            bad = rms1 > config.pose_reject_above_px
            keep = err1 <= config.pose_reject_sigma * rms1
            mask2 = mask & (keep | ~bad)
            # never reject below a minimum support (the solver needs >= 3 lanes)
            mask2 = torch.where(torch.sum(mask2, dim=-1)[..., None] >= 8, mask2, mask)
            res = solve_translation(intr, p, p3, res.x, mask2, config)
            mask = mask2
        t = res.x.to(dtype)

    p_proj = world_to_image(intr, R.to(dtype), t, p3)
    m = mask[..., None].to(dtype)
    err = (p - p_proj) * m
    nvalid = torch.clamp(2.0 * torch.sum(mask, dim=-1), min=1.0)
    rms = torch.sqrt(torch.sum(err * err, dim=(-2, -1)) / nvalid)
    return PoseResult(t=t, R=R, residual_rms=rms, p_proj=p_proj, iterations=res.iterations)
