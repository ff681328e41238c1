"""Small vector helpers (torch twin of ``velocity_tpu/geometry/norms.py``).

Semantics match the reference helpers ``norm``/``rms``/``uvec``/``addcol0``/
``addcol1`` (reference utils/common.py:13-39), broadcast over any leading
dimensions; ``dim=None`` reduces over every element.
"""

from __future__ import annotations

import torch


def norm(x, dim=None):
    """L2 norm of ``x`` over ``dim`` (all elements when ``dim`` is None)."""
    return torch.sqrt(torch.sum(x * x, dim=dim))


def rms(x, dim=None):
    """Root-mean-square of ``x`` over ``dim`` (all elements when ``dim`` is None)."""
    return torch.sqrt(torch.mean(x * x, dim=dim))


def masked_rms(x, mask, dim=None, eps=0.0):
    """RMS over entries where ``mask`` is True; masked-out entries contribute nothing."""
    m = mask.to(x.dtype)
    num = torch.sum(x * x * m, dim=dim)
    den = torch.clamp(torch.sum(m, dim=dim), min=1.0)
    return torch.sqrt(num / den + eps)


def unit_rows(x, dim=-1, eps=0.0):
    """Normalize vectors along ``dim`` to unit length (default: rows)."""
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)
    return x / n


def append_col(x, value):
    """Append a constant column ``value`` to the right of a (..., N, D) tensor."""
    pad = torch.full(x.shape[:-1] + (1,), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=-1)
