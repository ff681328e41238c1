"""Levenberg-Marquardt engine (torch twin of ``velocity_tpu/solvers/lm.py``).

Identity Marquardt damping, iteration-ramped step scale
``min(((i+1)*ramp_rate)^2, 1)``, convergence on ``rms(delta) < tol``, a fixed
iteration cap, and forward-mode Jacobians (``torch.func.jacfwd``). The JAX
``lax.while_loop`` becomes a Python loop whose condition reads ``rms(delta)``
on the host once per iteration.

Masking contract: ``residual_fn(x)`` returns the full static-shape residual
with invalid measurements already zeroed inside the function, so their
Jacobian rows vanish too.

Lanes (JAX's vmap of the ``while_loop``): ``x0`` (V, nx) and a residual
function (V, nx) -> (V, R) whose lane v reads only x[v]. The loop runs while
any lane is active, with one host read per iteration for all lanes; a lane
whose step fell below ``tol`` (or that reached the cap) is frozen: its x,
step rms and iteration count are kept, not stepped again. The residuals and
Jacobians of all lanes are evaluated at once (the Jacobian's columns by one
forward-mode pass per parameter, each lane's tangent the same unit vector);
each active lane's normal equations and solve run as its own call, which a
batched matrix product could change in the last bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd


class LMResult(NamedTuple):
    x: torch.Tensor
    iterations: int  # number of iterations executed (with lanes: a list, one per lane)
    delta_rms: torch.Tensor  # rms of last step
    residual_rms: torch.Tensor  # masked rms of residual at solution


def lm_solve(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    *,
    max_iters: int = 30,
    damping=1.0,
    tol: float = 1e-8,
    ramp_rate: float = 0.2,
    use_ramp: bool = True,
    num_residuals=None,
) -> LMResult:
    """Minimize ||residual_fn(x)||^2 with damped Gauss-Newton steps.

    ``residual_fn``: x -> r where r = z - zhat (masked entries zero).
    ``num_residuals``: count of *valid* residual entries for the reported rms
    (defaults to r.numel()). With lanes (``x0`` (V, nx)), ``damping`` and
    ``num_residuals`` are scalars or (V,).
    """
    if x0.dim() == 2:
        return _lm_solve_lanes(residual_fn, x0, max_iters=max_iters, damping=damping, tol=tol,
                               ramp_rate=ramp_rate, use_ramp=use_ramp,
                               num_residuals=num_residuals)
    dtype = x0.dtype
    dev = x0.device
    nx = x0.shape[0]
    eye = torch.eye(nx, dtype=dtype, device=dev) * torch.as_tensor(damping, dtype=dtype, device=dev)
    # dtype-aware convergence floor: 1e-8 is unreachable in f32
    tol = max(tol, 50.0 * float(torch.finfo(dtype).eps))
    jac = jacfwd(residual_fn)

    x = x0
    i = 0
    delta_rms = torch.tensor(float("inf"), dtype=dtype, device=dev)
    while i < max_iters and bool(delta_rms >= tol):
        r, J = residual_fn(x), jac(x)
        # r = z - zhat, J = dr/dx = -dzhat/dx
        g = -(J.T @ r)
        H = J.T @ J + eye
        delta = torch.linalg.solve(H, g)
        if use_ramp:
            delta = delta * min(((i + 1.0) * ramp_rate) ** 2, 1.0)
        x = x + delta
        i += 1
        delta_rms = torch.sqrt(torch.sum(delta * delta) / delta.numel())
    r = residual_fn(x)
    if num_residuals is None:
        n = torch.tensor(float(r.numel()), dtype=dtype, device=dev)
    else:
        n = torch.clamp(torch.as_tensor(num_residuals, dtype=dtype, device=dev), min=1.0)
    return LMResult(x=x, iterations=i, delta_rms=delta_rms,
                    residual_rms=torch.sqrt(torch.sum(r * r) / n))


def _lm_solve_lanes(residual_fn, x0, *, max_iters, damping, tol, ramp_rate, use_ramp,
                    num_residuals) -> LMResult:
    """``lm_solve`` over the lanes of ``x0`` (V, nx): each lane's iterates,
    step rms and count are those of its own call."""
    dtype = x0.dtype
    dev = x0.device
    V, nx = x0.shape
    damping = torch.as_tensor(damping, dtype=dtype, device=dev).expand(V)
    eyes = [torch.eye(nx, dtype=dtype, device=dev) * damping[v] for v in range(V)]
    tol = max(tol, 50.0 * float(torch.finfo(dtype).eps))
    basis = torch.eye(nx, dtype=dtype, device=dev)[:, None, :].expand(nx, V, nx)

    def jac(x):  # (V, R, nx): column k is the tangent of e_k in every lane
        cols = torch.func.vmap(lambda e: torch.func.jvp(residual_fn, (x,), (e,))[1])(basis)
        return cols.permute(1, 2, 0)

    x = x0
    iters = [0] * V
    delta_rms = torch.full((V,), float("inf"), dtype=dtype, device=dev)
    active = [max_iters > 0] * V
    while any(active):
        r, J = residual_fn(x), jac(x)
        deltas = torch.zeros_like(x)
        for v in (v for v in range(V) if active[v]):
            # r = z - zhat, J = dr/dx = -dzhat/dx
            g = -(J[v].T @ r[v])
            H = J[v].T @ J[v] + eyes[v]
            delta = torch.linalg.solve_ex(H, g).result  # H is SPD: solve's check never fires
            if use_ramp:
                delta = delta * min(((iters[v] + 1.0) * ramp_rate) ** 2, 1.0)
            deltas[v] = delta
            iters[v] += 1
        on = torch.tensor(active, device=dev)
        x = torch.where(on[:, None], x + deltas, x)
        rms = torch.sqrt(torch.sum(deltas * deltas, dim=-1) / nx)
        delta_rms = torch.where(on, rms, delta_rms)
        going = (delta_rms >= tol).tolist()  # the one host read of the iteration
        active = [going[v] and iters[v] < max_iters for v in range(V)]
    r = residual_fn(x)
    if num_residuals is None:
        n = torch.full((V,), float(r.shape[-1]), dtype=dtype, device=dev)
    else:
        n = torch.clamp(torch.as_tensor(num_residuals, dtype=dtype, device=dev), min=1.0)
    return LMResult(x=x, iterations=iters, delta_rms=delta_rms,
                    residual_rms=torch.sqrt(torch.sum(r * r, dim=-1) / n))
