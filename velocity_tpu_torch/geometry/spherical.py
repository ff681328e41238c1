"""Spherical and NED conversions (torch twin of ``velocity_tpu/geometry/spherical.py``)."""

from __future__ import annotations

import numpy as np
import torch

# +X_ned(NORTH)=+Z_cam, +Y_ned(EAST)=+X_cam, +Z_ned(DOWN)=+Y_cam.
CAM_TO_NED = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], dtype=np.float64)


def cam_to_ned_matrix(dtype=torch.float32, device=None):
    """The camera->NED permutation matrix as a tensor."""
    return torch.as_tensor(CAM_TO_NED, dtype=dtype, device=device)


def elevation_azimuth(x):
    """Cartesian (..., 3) -> [elevation, azimuth] (..., 2) in radians."""
    r = torch.sqrt(torch.sum(x * x, dim=-1))
    el = torch.asin(-x[..., 2] / r)
    az = torch.atan2(x[..., 1], x[..., 0])
    return torch.stack([el, az], dim=-1)


def cartesian_to_spherical(x):
    """Cartesian (..., 3) -> spherical [range, elevation, azimuth] (..., 3)."""
    r = torch.sqrt(torch.sum(x * x, dim=-1))
    el = torch.asin(-x[..., 2] / r)
    az = torch.atan2(x[..., 1], x[..., 0])
    return torch.stack([r, el, az], dim=-1)


def spherical_to_cartesian(s):
    """Spherical [range, elevation, azimuth] (..., 3) -> cartesian (..., 3)."""
    r, el, az = s[..., 0], s[..., 1], s[..., 2]
    a = r * torch.cos(el)
    return torch.stack([a * torch.cos(az), a * torch.sin(az), -r * torch.sin(el)], dim=-1)
