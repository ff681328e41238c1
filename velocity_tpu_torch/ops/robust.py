"""Masked robust statistics (torch twin of ``velocity_tpu/ops/robust.py``).

``sigma_rejection`` is the reference's ``fcnsigmarejection``: rounds of
clipping to mean +/- srl*std, as masked reductions over static shapes.
"""

from __future__ import annotations

import torch


def sigma_rejection(x, mask=None, srl: float = 3.0, iterations: int = 3):
    """Iterative sigma clipping; returns the mask of surviving elements.

    The std is the population std (ddof=0) over the elements that survive so
    far; both inequalities are strict.
    """
    x = torch.as_tensor(x)
    v = torch.ones(x.shape, dtype=torch.bool, device=x.device) if mask is None else mask
    for _ in range(iterations):
        m = v.to(x.dtype)
        n = torch.clamp(torch.sum(m), min=1.0)
        mu = torch.sum(x * m) / n
        var = torch.sum((x - mu) ** 2 * m) / n
        s = torch.sqrt(var) * srl
        v = v & (x < mu + s) & (x > mu - s)
    return v
