"""Small vector helpers (torch twin of ``velocity_tpu/geometry/norms.py``)."""

from __future__ import annotations

import torch


def unit_rows(x, dim=-1, eps=0.0):
    """Normalize vectors along ``dim`` to unit length (default: rows)."""
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)
    return x / n
