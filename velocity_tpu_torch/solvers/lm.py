"""Levenberg-Marquardt engine (torch twin of ``velocity_tpu/solvers/lm.py``).

Identity Marquardt damping, iteration-ramped step scale
``min(((i+1)*ramp_rate)^2, 1)``, convergence on ``rms(delta) < tol``, a fixed
iteration cap, and forward-mode Jacobians (``torch.func.jacfwd``). The JAX
``lax.while_loop`` becomes a Python loop whose condition reads ``rms(delta)``
on the host once per iteration.

Masking contract: ``residual_fn(x)`` returns the full static-shape residual
with invalid measurements already zeroed inside the function, so their
Jacobian rows vanish too.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd


class LMResult(NamedTuple):
    x: torch.Tensor
    iterations: int  # number of iterations executed
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
    (defaults to r.numel()).
    """
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
