"""Block-sparse Gauss-Newton bundle adjustment with the Schur-complement
camera reduction (torch twin of ``velocity_tpu/solvers/schur.py``).

Identical iterates to ``ba_dense`` (same normal equations
H = [[U, W], [W^T, V]], same damping and step rules) but H is never formed:
the per-observation 2x3 point and 2x6 camera Jacobian blocks are assembled
analytically on the dense (nc, nt) observation grid as batched einsums, the
3x3 point blocks are inverted batched, and only the reduced (6 nc)^2 camera
system is solved.

The function split is the one a point-sharded solve needs: the point axis
(nt) partitions across devices, what ``schur_camera_partials`` returns is
summed over them before ``schur_assemble_solve``, the small camera solve is
replicated, and ``schur_backsub`` is local to a shard. Cost per iteration:
O(nc*nt) small-block math + the O((6 nc)^3) solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from velocity_tpu_torch.config import BAConfig
from velocity_tpu_torch.geometry.projection import Intrinsics
from velocity_tpu_torch.geometry.rotations import rpy_to_matrix, rpy_to_matrix_jacobian
from velocity_tpu_torch.solvers.ba import BAProblem, BAResult, ba_residual_rms, step_tolerance

# A CG solve reads its stopping test back to the host once per this many
# iterations; between reads a converged solve is held still on the device.
CG_CHECK_EVERY = 10


class BABlocks(NamedTuple):
    """Per-iteration block quantities on the (nc, nt) observation grid."""

    r: torch.Tensor  # (nc, nt, 2) normalized masked residuals (z - zhat)/fx
    A: torch.Tensor  # (nc, nt, 2, 3) d zhat_n / d point
    B: torch.Tensor  # (nc, nt, 2, 6) d zhat_n / d [pos, rpy] (zero for cam 0)


def compute_blocks(
    intr: Intrinsics, problem: BAProblem, points, cams, fix_rotations: bool = False
) -> BABlocks:
    """Analytic residual + Jacobian blocks for all observations.

    ``fix_rotations``: zero the rpy Jacobian columns, so cameras optimize
    translation only (the driver's motion model; rotations stay at their
    initial values). The damping keeps the reduced system non-singular and
    the rpy deltas exactly zero.
    """
    nc = cams.shape[0]
    inv_f = 1.0 / intr.fx

    C = rpy_to_matrix(cams[:, 3:6])  # (nc, 3, 3)
    dC = rpy_to_matrix_jacobian(cams[:, 3:6])  # (nc, 3, 3, 3) [i, j, param]
    pc = torch.einsum("tm,cmk->ctk", points, C) + cams[:, None, 0:3]  # (nc, nt, 3)

    X, Y, Z = pc[..., 0], pc[..., 1], pc[..., 2]
    iz = 1.0 / Z
    u = (intr.fx * X + intr.skew * Y) * iz + intr.cx
    v = intr.fy * Y * iz + intr.cy
    zhat = torch.stack([u, v], dim=-1)
    m = problem.mask[..., None]
    r = torch.where(m, problem.pixels - zhat, 0.0) * inv_f

    # L = d zhat_n / d pc : (nc, nt, 2, 3), masked
    a = intr.fx * X + intr.skew * Y
    zero = torch.zeros_like(iz)
    L = torch.stack(
        [
            torch.stack([intr.fx * iz, intr.skew * iz, -a * iz * iz], dim=-1),
            torch.stack([zero, intr.fy * iz, -intr.fy * Y * iz * iz], dim=-1),
        ],
        dim=-2,
    ) * inv_f
    L = torch.where(m[..., None], L, 0.0)

    # A = L @ C^T  (d pc_k / d pw_m = C[m, k])
    A = torch.einsum("ctik,cmk->ctim", L, C)  # (nc, nt, 2, 3)

    # B: position part = L; rpy part = L @ (pw @ dC)
    dpc_drpy = torch.einsum("tm,cmkp->ctkp", points, dC)  # (nc, nt, 3, 3 params)
    B_rpy = torch.einsum("ctik,ctkp->ctip", L, dpc_drpy)  # (nc, nt, 2, 3)
    if fix_rotations:
        B_rpy = torch.zeros_like(B_rpy)
    B = torch.cat([L, B_rpy], dim=-1)  # (nc, nt, 2, 6)
    cam_free = (torch.arange(nc, device=cams.device) > 0)[:, None, None, None]
    B = torch.where(cam_free, B, 0.0)
    return BABlocks(r=r, A=A, B=B)


def _damping(damping, like):
    """``damping`` (a float or a 0-d tensor) on ``like``'s device and dtype."""
    return torch.as_tensor(damping, dtype=like.dtype, device=like.device)


def schur_point_blocks(blocks: BABlocks, damping, dtype):
    """Per-point quantities (no cross-point coupling: local to a shard).

    Returns (Vinv (nt, 3, 3), gp (nt, 3), W (nc, nt, 6, 3)).
    """
    r, A, B = blocks
    lam = _damping(damping, A)
    V = torch.einsum("ctim,ctin->tmn", A, A) + lam * torch.eye(3, dtype=dtype, device=A.device)
    W = torch.einsum("ctia,ctim->ctam", B, A)
    gp = torch.einsum("ctim,cti->tm", A, r)
    Vinv = torch.linalg.inv(V)
    return Vinv, gp, W


def schur_camera_partials(blocks: BABlocks, Vinv, gp, W):
    """Point-summed contributions to the camera system: the quantities a
    point-sharded solve sums over its shards.

    Returns (U (nc, 6, 6), SW (nc, nc, 6, 6), gc (nc, 6), rhs_red (nc, 6));
    the reduced system is S = diag(U + lam I) - SW, rhs = gc - rhs_red.
    """
    r, A, B = blocks
    U = torch.einsum("ctia,ctib->cab", B, B)
    gc = torch.einsum("ctia,cti->ca", B, r)
    WVinv = torch.einsum("ctam,tmn->ctan", W, Vinv)
    SW = torch.einsum("ctan,dtbn->cdab", WVinv, W)
    rhs_red = torch.einsum("ctan,tn->ca", WVinv, gp)
    return U, SW, gc, rhs_red


def _assemble(U, SW, gc, rhs_red, damping, dtype):
    """The reduced camera system (S (6 nc, 6 nc), b (6 nc,)) with camera 0
    pinned: its rows and columns zeroed, its diagonal block the identity."""
    nc = U.shape[0]
    dev = U.device
    lam = _damping(damping, U)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    diag = U + lam * eye6
    S_blocks = -SW + torch.einsum("cab,cd->cdab", diag, torch.eye(nc, dtype=dtype, device=dev))
    rhs_c = gc - rhs_red

    free = (torch.arange(nc, device=dev) > 0).to(dtype)
    S_blocks = S_blocks * free[:, None, None, None] * free[None, :, None, None]
    S_blocks[0, 0] = eye6
    rhs_c = rhs_c * free[:, None]

    S = S_blocks.permute(0, 2, 1, 3).reshape(nc * 6, nc * 6)
    return S, rhs_c.reshape(nc * 6)


def cg_jacobi(S, b, tol: float, max_iters: int):
    """Jacobi-preconditioned conjugate gradients for the SPD system S x = b,
    from x = 0, until ``||r||^2 <= tol^2 ||b||^2`` or ``max_iters``. A zero
    diagonal entry preconditions with 1.

    Once the test is met every further update leaves the iterate as it is,
    so the result is that of a loop that stops there; the host reads the
    test only every ``CG_CHECK_EVERY`` iterations.
    """
    d = torch.diagonal(S)
    Minv = torch.where(torch.abs(d) > 0, 1.0 / d, torch.ones_like(d))
    atol2 = tol * tol * torch.dot(b, b)
    x = torch.zeros_like(b)
    r = b
    p = Minv * r
    gamma = torch.dot(r, p)
    for k in range(max_iters):
        active = torch.dot(r, r) > atol2
        if k % CG_CHECK_EVERY == 0 and not bool(active):
            break
        Ap = S @ p
        alpha = gamma / torch.dot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = Minv * r_new
        gamma_new = torch.dot(r_new, z)
        p_new = z + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
    return x


def _solve_cameras(S, b, cg_tol: float, cg_max_iters: int):
    if cg_max_iters > 0:
        return cg_jacobi(S, b, cg_tol, cg_max_iters)
    return torch.linalg.solve(S, b)


def schur_assemble_solve(U, SW, gc, rhs_red, damping, dtype,
                         cg_tol: float = 0.0, cg_max_iters: int = 0):
    """Assemble the reduced camera system, pin camera 0, solve for dc (nc*6,).

    ``cg_max_iters > 0`` solves by Jacobi-preconditioned conjugate gradients
    instead of the dense factorization: the reduced camera matrix is SPD
    (damped Gauss-Newton), and for long windows the O((6 nc)^3) dense solve
    overtakes the O(iters (6 nc)^2) of CG.
    """
    S, b = _assemble(U, SW, gc, rhs_red, damping, dtype)
    return _solve_cameras(S, b, cg_tol, cg_max_iters)


def schur_reduce(blocks: BABlocks, damping, dtype):
    """Single-device path: the point blocks and the assembled camera system.

    Returns (S, rhs, Vinv, gp, W).
    """
    Vinv, gp, W = schur_point_blocks(blocks, damping, dtype)
    S, rhs = _assemble(*schur_camera_partials(blocks, Vinv, gp, W), damping, dtype)
    return S, rhs, Vinv, gp, W


def schur_backsub(Vinv, gp, W, dc):
    """Point updates: dp_t = Vinv_t (gp_t - sum_c W_ct^T dc_c)."""
    nc = W.shape[0]
    dcb = dc.reshape(nc, 6)
    Wt_dc = torch.einsum("ctam,ca->tm", W, dcb)  # (nt, 3)
    return torch.einsum("tmn,tn->tm", Vinv, gp - Wt_dc)


def ba_schur(
    problem: BAProblem, config: BAConfig = BAConfig(), fix_rotations: bool = False
) -> BAResult:
    """Schur-complement BA on the device of ``problem``'s tensors; same
    optimum and iterates as ``ba_dense``."""
    intr = problem.intr
    dtype = problem.points0.dtype
    nc = problem.cams0.shape[0]
    inv_f = 1.0 / intr.fx
    lam = config.damping * inv_f * inv_f  # damping matched to normalized residuals
    tol = step_tolerance(config, dtype)
    cg_iters = config.cg_max_iters if config.camera_solver == "cg" else 0

    points, cams, i, d = problem.points0, problem.cams0, 0, float("inf")
    while i < config.max_iters and d >= tol:
        blocks = compute_blocks(intr, problem, points, cams, fix_rotations)
        S, rhs, Vinv, gp, W = schur_reduce(blocks, lam, dtype)
        dc_raw = _solve_cameras(S, rhs, config.cg_tol, cg_iters)
        dp = schur_backsub(Vinv, gp, W, dc_raw) * config.step_scale
        dcams = dc_raw.reshape(nc, 6) * config.step_scale
        points = points + dp
        cams = cams + dcams
        nx = dp.numel() + (nc - 1) * 6
        i += 1
        d = float(torch.sqrt((torch.sum(dp * dp) + torch.sum(dcams[1:] ** 2)) / nx))
    return BAResult(points=points, cams=cams, iterations=i,
                    residual_rms=ba_residual_rms(problem, points, cams))
