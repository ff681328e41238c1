"""Levenberg-Marquardt engine (torch twin of ``velocity_tpu/solvers/lm.py``).

Identity Marquardt damping, iteration-ramped step scale
``min(((i+1)*ramp_rate)^2, 1)``, convergence on ``rms(delta) < tol``, a fixed
iteration cap, and forward-mode Jacobians (``torch.func.jacfwd``).

The JAX ``lax.while_loop`` has two forms here (``utils/loops.py``). Run
eagerly, the loop's condition reads ``rms(delta)`` on the host once per
iteration and stops there (the host MSV, whose cap is 1,000 iterations, and
every eager frame step). Where the frame step is captured in a CUDA graph
(``utils.loops.fixed_trips()``), it runs ``max_iters`` iterations with no
host read: once ``i >= max_iters or rms(delta) < tol``, x, the step rms and
the iteration count (a device tensor) are frozen by ``torch.where``, which
is what the ``while_loop`` leaves. Both forms give the same x, step rms and
count, bit for bit: a frozen iteration computes a step and keeps nothing of
it.

Masking contract: ``residual_fn(x)`` returns the full static-shape residual
with invalid measurements already zeroed inside the function, so their
Jacobian rows vanish too.

Lanes (JAX's vmap of the ``while_loop``): ``x0`` (V, nx) and a residual
function (V, nx) -> (V, R) whose lane v reads only x[v]. Each lane is
frozen at its own stop, with its own iteration count and ramp, as the vmap
of a ``while_loop`` freezes it; run eagerly, the loop stops once every lane
has (one host read per iteration for all lanes). The residuals
and Jacobians of all lanes are evaluated at once (the Jacobian's columns by
one forward-mode pass per parameter, each lane's tangent the same unit
vector); each lane's normal equations and solve run as its own call, which
a batched matrix product could change in the last bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd

from velocity_tpu_torch.utils.loops import fixed_trips


class LMResult(NamedTuple):
    x: torch.Tensor
    iterations: int | torch.Tensor  # iterations executed; captured or with lanes: int64 ((V,))
    delta_rms: torch.Tensor  # rms of last step
    residual_rms: torch.Tensor  # masked rms of residual at solution


def _scalar(v, dtype, dev):
    """``v`` (a number or a tensor) as a tensor of ``dtype`` on ``dev``, a
    number without a host-to-device copy."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=dev)
    return torch.full((), float(v), dtype=dtype, device=dev)


def _ramp(i: int, ramp_rate: float) -> float:
    """The step scale of iteration ``i`` (0-based)."""
    return min(((i + 1.0) * ramp_rate) ** 2, 1.0)


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
    eye = torch.eye(nx, dtype=dtype, device=dev) * _scalar(damping, dtype, dev)
    # dtype-aware convergence floor: 1e-8 is unreachable in f32
    tol = max(tol, 50.0 * float(torch.finfo(dtype).eps))
    jac = jacfwd(residual_fn)

    frozen = fixed_trips()
    x = x0
    i = 0
    delta_rms = torch.full((), float("inf"), dtype=dtype, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev) if frozen else None
    while i < max_iters and (frozen or bool(delta_rms >= tol)):
        r, J = residual_fn(x), jac(x)
        # r = z - zhat, J = dr/dx = -dzhat/dx
        g = -(J.T @ r)
        H = J.T @ J + eye
        delta = torch.linalg.solve_ex(H, g).result  # H is SPD: solve's check never fires
        if use_ramp:
            delta = delta * _ramp(i, ramp_rate)
        rms = torch.sqrt(torch.sum(delta * delta) / delta.numel())
        if frozen:
            on = delta_rms >= tol  # not yet converged; the cap is the loop's
            x = torch.where(on, x + delta, x)
            delta_rms = torch.where(on, rms, delta_rms)
            count = count + on
        else:
            x = x + delta
            delta_rms = rms
        i += 1
    r = residual_fn(x)
    if num_residuals is None:
        n = torch.full((), float(r.numel()), dtype=dtype, device=dev)
    else:
        n = torch.clamp(_scalar(num_residuals, dtype, dev), min=1.0)
    return LMResult(x=x, iterations=count if frozen else i, delta_rms=delta_rms,
                    residual_rms=torch.sqrt(torch.sum(r * r) / n))


def _lm_solve_lanes(residual_fn, x0, *, max_iters, damping, tol, ramp_rate, use_ramp,
                    num_residuals) -> LMResult:
    """``lm_solve`` over the lanes of ``x0`` (V, nx): each lane's iterates,
    step rms and count are those of its own call."""
    dtype = x0.dtype
    dev = x0.device
    V, nx = x0.shape
    damping = _scalar(damping, dtype, dev).expand(V)
    eyes = [torch.eye(nx, dtype=dtype, device=dev) * damping[v] for v in range(V)]
    tol = max(tol, 50.0 * float(torch.finfo(dtype).eps))
    basis = torch.eye(nx, dtype=dtype, device=dev)[:, None, :].expand(nx, V, nx)

    def jac(x):  # (V, R, nx): column k is the tangent of e_k in every lane
        cols = torch.func.vmap(lambda e: torch.func.jvp(residual_fn, (x,), (e,))[1])(basis)
        return cols.permute(1, 2, 0)

    fixed = fixed_trips()
    x = x0
    count = torch.zeros((V,), dtype=torch.int64, device=dev)
    delta_rms = torch.full((V,), float("inf"), dtype=dtype, device=dev)
    for i in range(max_iters):
        if not fixed and not bool(torch.any(delta_rms >= tol)):
            break  # every lane has stopped: the one host read of the iteration
        r, J = residual_fn(x), jac(x)
        deltas = []
        for v in range(V):
            # r = z - zhat, J = dr/dx = -dzhat/dx
            g = -(J[v].T @ r[v])
            H = J[v].T @ J[v] + eyes[v]
            delta = torch.linalg.solve_ex(H, g).result  # H is SPD: solve's check never fires
            # a lane still going at iteration i has made i steps: its ramp is i's
            deltas.append(delta * _ramp(i, ramp_rate) if use_ramp else delta)
        deltas = torch.stack(deltas)
        on = delta_rms >= tol  # the lanes not yet converged; the cap is the loop's
        x = torch.where(on[:, None], x + deltas, x)
        rms = torch.sqrt(torch.sum(deltas * deltas, dim=-1) / nx)
        delta_rms = torch.where(on, rms, delta_rms)
        count = count + on
    r = residual_fn(x)
    if num_residuals is None:
        n = torch.full((V,), float(r.shape[-1]), dtype=dtype, device=dev)
    else:
        n = torch.clamp(_scalar(num_residuals, dtype, dev), min=1.0)
    return LMResult(x=x, iterations=count, delta_rms=delta_rms,
                    residual_rms=torch.sqrt(torch.sum(r * r, dim=-1) / n))
