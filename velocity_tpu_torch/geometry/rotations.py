"""Rotation parameterizations: roll-pitch-yaw <-> direction cosine matrices.

Torch twin of ``velocity_tpu/geometry/rotations.py``: the DCM applies to
row-vector points as ``x @ C``, and ``matrix_to_rpy`` keeps the reference's
``atan`` (not ``atan2``) for roll.
"""

from __future__ import annotations

import torch


def rpy_to_matrix(rpy):
    """(..., 3) roll, pitch, yaw -> (..., 3, 3) DCM ``C`` (points transform as ``x @ C``)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    sr, cr = torch.sin(r), torch.cos(r)
    sp, cp = torch.sin(p), torch.cos(p)
    sy, cy = torch.sin(y), torch.cos(y)

    row0 = torch.stack([cp * cy, sr * sp * cy - cr * sy, cr * sp * cy + sr * sy], dim=-1)
    row1 = torch.stack([cp * sy, sr * sp * sy + cr * cy, cr * sp * sy - sr * cy], dim=-1)
    row2 = torch.stack([-sp, sr * cp, cr * cp], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rpy_to_matrix_jacobian(rpy):
    """(..., 3) roll, pitch, yaw -> (..., 3, 3, 3) derivative of
    ``rpy_to_matrix``, laid out ``[i, j, param]``: the three derivative
    matrices written out, so that a solver's inner loop needs no
    differentiation pass."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    sr, cr = torch.sin(r), torch.cos(r)
    sp, cp = torch.sin(p), torch.cos(p)
    sy, cy = torch.sin(y), torch.cos(y)
    zero = torch.zeros_like(r)

    def matrix(rows):
        return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)

    d_roll = matrix([[zero, cr * sp * cy + sr * sy, -sr * sp * cy + cr * sy],
                     [zero, cr * sp * sy - sr * cy, -sr * sp * sy - cr * cy],
                     [zero, cr * cp, -sr * cp]])
    d_pitch = matrix([[-sp * cy, sr * cp * cy, cr * cp * cy],
                      [-sp * sy, sr * cp * sy, cr * cp * sy],
                      [-cp, -sr * sp, -cr * sp]])
    d_yaw = matrix([[-cp * sy, -sr * sp * sy - cr * cy, -cr * sp * sy + sr * cy],
                    [cp * cy, sr * sp * cy - cr * sy, cr * sp * cy + sr * sy],
                    [zero, zero, zero]])
    return torch.stack([d_roll, d_pitch, d_yaw], dim=-1)


def matrix_to_rpy(C):
    """[roll, pitch, yaw] from a DCM: roll ``atan(C21/C22)``, pitch
    ``asin(-C20)``, yaw ``atan2(C10, C00)``."""
    roll = torch.atan(C[..., 2, 1] / C[..., 2, 2])
    pitch = torch.asin(-C[..., 2, 0])
    yaw = torch.atan2(C[..., 1, 0], C[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def rotate_translate(points, rpy, t):
    """Fused rotate+translate: ``points @ rpy_to_matrix(rpy) + t`` for
    (..., N, 3) row-vector points, (..., 3) roll-pitch-yaw and a (..., 3)
    translation broadcast over the points (reference ``transform``,
    utils/transforms.py:27-48)."""
    return points @ rpy_to_matrix(rpy) + t[..., None, :]
