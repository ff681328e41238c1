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

Accepted steps (``accept_steps=True``, one unknown vector, run eagerly
only): each damped step is a trial, kept only where the cost fell, with the
damping adapted by the gain ratio as Nielsen's rule adapts it (Madsen,
Nielsen & Tingleff, "Methods for non-linear least squares problems", 2004,
Algorithm 3.16). The form above, which takes every step, is JAX's and
upstream's (``MSV.py:28-42``); it stays the default and keeps its bits.
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
    rejected: int = 0  # trial steps refused (the accepted-step form; else 0)


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
    accept_steps: bool = False,
    jacobian_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> LMResult:
    """Minimize ||residual_fn(x)||^2 with damped Gauss-Newton steps.

    ``residual_fn``: x -> r where r = z - zhat (masked entries zero).
    ``num_residuals``: count of *valid* residual entries for the reported rms
    (defaults to r.numel()). With lanes (``x0`` (V, nx)), ``damping`` and
    ``num_residuals`` are scalars or (V,). ``accept_steps``: keep a step
    only where the cost fell (``_lm_solve_accepted``), ``damping`` its
    first damping; ``jacobian_fn`` (x -> dr/dx, that form only) replaces
    the forward-mode Jacobian there.
    """
    if accept_steps:
        if use_ramp:
            raise ValueError("the accepted-step LM takes no ramp: its cost test sizes the steps")
        return _lm_solve_accepted(residual_fn, x0, max_iters=max_iters, damping=damping,
                                  tol=tol, num_residuals=num_residuals, jacobian_fn=jacobian_fn)
    if jacobian_fn is not None:
        raise ValueError("jacobian_fn is the accepted-step form's")
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
    return LMResult(x=x, iterations=count if frozen else i, delta_rms=delta_rms,
                    residual_rms=_residual_rms(residual_fn(x), num_residuals, dtype, dev))


def _residual_rms(r, num_residuals, dtype, dev):
    """The rms of ``r`` over ``num_residuals`` valid entries (all of them
    where None), the count in the unknowns' ``dtype``."""
    if num_residuals is None:
        n = torch.full((), float(r.numel()), dtype=dtype, device=dev)
    else:
        n = torch.clamp(_scalar(num_residuals, dtype, dev), min=1.0)
    return torch.sqrt(torch.sum(r * r) / n)


def _lm_solve_accepted(residual_fn, x0, *, max_iters, damping, tol, num_residuals,
                       jacobian_fn=None) -> LMResult:
    """``lm_solve`` with a cost test on every step (one unknown vector x0
    (nx,)).

    Each iteration solves (J^T J + mu I) delta = -J^T r at the current x
    and evaluates the cost ||r||^2 at x + delta. The gain ratio rho is the
    cost's fall over the fall that the linear model predicts,
    delta^T (mu delta - J^T r). Where rho > 0 the step is taken, the
    Jacobian is evaluated anew and mu shrinks by max(1/3, 1 - (2 rho - 1)^3);
    else x stays, mu grows by nu and nu doubles (Nielsen's rule). mu starts
    at ``damping``.

    The stop is the take-every-step form's own test, made at every x the
    solve reaches: the step at the first damping,
    (J^T J + damping I)^-1 (-J^T r), has an rms below ``tol``. That step
    is then the last trial, taken unless the cost rose, as that form takes
    its last step; its rms is ``delta_rms``. The step actually tried is no
    measure of convergence: a damping grown by refused trials shrinks it far
    from the minimum. The solve also stops where a refused trial's step is
    below ``tol`` (no smaller step lowers the cost in this precision), and
    at ``max_iters`` trials. ``iterations`` counts the trials, ``rejected``
    the refused ones.

    The cost test reads the host once a trial, so there is no captured form:
    under ``utils.loops.fixed_trips()`` this raises.
    """
    if fixed_trips():
        raise RuntimeError("the accepted-step LM reads its cost on the host every trial: "
                           "it has no captured form")
    if x0.dim() != 1:
        raise ValueError(f"the accepted-step LM takes one unknown vector, not {tuple(x0.shape)}")
    dtype, dev = x0.dtype, x0.device
    nx = x0.shape[0]
    eye = torch.eye(nx, dtype=dtype, device=dev)
    tol = max(tol, 50.0 * float(torch.finfo(dtype).eps))
    jac = jacfwd(residual_fn) if jacobian_fn is None else jacobian_fn
    mu0 = float(damping)

    def step(JtJ, g, mu):
        delta = torch.linalg.solve_ex(JtJ + mu * eye, g).result  # SPD: the check never fires
        return delta, torch.sqrt(torch.sum(delta * delta) / nx)

    def linearize(x, r):
        J = jac(x)
        JtJ, g = J.T @ J, -(J.T @ r)
        return float(torch.sum(r * r)), JtJ, g, step(JtJ, g, mu0)

    x = x0
    r = residual_fn(x)
    cost, JtJ, g, (delta0, rms0) = linearize(x, r)
    mu, nu = mu0, 2.0
    moved = True  # a step taken since mu was last set to mu0
    delta_rms = torch.full((), float("inf"), dtype=dtype, device=dev)
    i = rejected = 0
    while i < max_iters:
        last = bool(rms0 < tol)
        delta, rms = (delta0, rms0) if last else step(JtJ, g, mu)
        i += 1
        r_try = residual_fn(x + delta)
        cost_try = float(torch.sum(r_try * r_try))
        if last:
            delta_rms = rms
            if cost_try <= cost:
                x, r = x + delta, r_try
            else:
                rejected += 1
            break
        fall = float(delta @ (mu * delta + g))  # the model's; > 0 unless delta is 0
        rho = (cost - cost_try) / fall if fall > 0 else float("nan")  # nan: refused
        if rho > 0:
            x, r, moved = x + delta, r_try, True
            cost, JtJ, g, (delta0, rms0) = linearize(x, r)
            mu *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
        else:
            rejected += 1
            if bool(rms < tol):
                if not moved:
                    delta_rms = rms
                    break
                mu, nu, moved = mu0, 2.0, False
                continue
            mu *= nu
            nu *= 2.0
    return LMResult(x=x, iterations=i, delta_rms=delta_rms,
                    residual_rms=_residual_rms(r, num_residuals, dtype, dev), rejected=rejected)


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
