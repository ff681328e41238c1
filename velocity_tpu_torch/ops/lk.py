"""LK result type and the per-level affine map (from ``velocity_tpu/ops/lk.py``).

Only what the lanes engine needs is ported; the gather LK (``lk_pyramidal``)
is the JAX package's reference path and is not on the port's main path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LKResult(NamedTuple):
    points: torch.Tensor  # (N, 2) tracked points (source-frame coords if warp_dst)
    status: torch.Tensor  # (N,) bool


def _affine_for_level(M, level, dtype):
    """Level-L sampling map: linear part unchanged, translation / 2^L."""
    if M is None:
        return None
    M = M.to(dtype)
    s = 1.0 / (1 << level)
    return torch.cat([M[:, :2], M[:, 2:3] * s], dim=1)
