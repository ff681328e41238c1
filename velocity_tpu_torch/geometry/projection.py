"""Pinhole projection, plane backprojection and pixel->ray conversion.

Torch twin of ``velocity_tpu/geometry/projection.py``. ``Intrinsics`` holds
0-d tensors; ``.to(dtype, device)`` moves all five at once. ``stack`` gives
one camera per lane (each entry (V,)), as JAX's ``run_batch`` stacks them;
``project_camera_points`` and ``world_to_image`` then take points with the
same leading lane axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from velocity_tpu_torch.geometry.norms import unit_rows
from velocity_tpu_torch.geometry.spherical import cam_to_ned_matrix, elevation_azimuth


class Intrinsics(NamedTuple):
    """Pinhole intrinsics; every entry is a 0-d tensor."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    skew: torch.Tensor

    def to(self, dtype=None, device=None):
        return Intrinsics(*(torch.as_tensor(v).to(dtype=dtype, device=device) for v in self))

    @classmethod
    def stack(cls, intrs):
        """One camera per lane: each entry the (V,) stack of the lanes'."""
        return cls(*(torch.stack([torch.as_tensor(v) for v in vals]) for vals in zip(*intrs)))

    @classmethod
    def from_matrix_rowvec(cls, K):
        """Build from the reference's row-vector intrinsic matrix layout."""
        K = torch.as_tensor(K)
        return cls(fx=K[0, 0], fy=K[1, 1], cx=K[2, 0], cy=K[2, 1], skew=K[1, 0])

    def matrix_rowvec(self, dtype=None):
        """Row-vector intrinsic matrix ``[[fx,0,0],[skew,fy,0],[cx,cy,1]]``."""
        fx, fy, cx, cy, skew = (torch.as_tensor(v, dtype=dtype) for v in self)
        z = torch.zeros_like(fx)
        o = torch.ones_like(fx)
        return torch.stack([torch.stack([fx, z, z]), torch.stack([skew, fy, z]),
                            torch.stack([cx, cy, o])])


def perspective_divide(p3):
    """(..., 3) homogeneous camera points -> (..., 2) normalized image points
    (reference ``pscale``, utils/common.py:145-147)."""
    return p3[..., 0:2] / p3[..., 2:3]


def _lane_entry(c, x):
    """An intrinsic entry against (V, ...) values ``x``: 0-d as it is, one
    per lane (V,) with ``x``'s trailing axes added."""
    if not torch.is_tensor(c) or c.dim() == 0:
        return c
    return c.reshape(c.shape + (1,) * (x.dim() - c.dim()))


def project_camera_points(intr: Intrinsics, pc):
    """Project camera-frame points (..., 3) to pixels (..., 2); with lane
    intrinsics (``Intrinsics.stack``), points (V, ..., 3)."""
    X, Y, Z = pc[..., 0], pc[..., 1], pc[..., 2]
    fx, fy, cx, cy, skew = (_lane_entry(c, X) for c in intr)
    iz = 1.0 / Z
    u = (fx * X + skew * Y) * iz + cx
    v = fy * Y * iz + cy
    return torch.stack([u, v], dim=-1)


def world_to_image(intr: Intrinsics, C, t, pw):
    """Pixels of world points ``pw`` (N, 3) through pose (C, t):
    ``pw @ C + t``; with lanes, pw (V, N, 3), t (V, 3), C (3, 3) or
    (V, 3, 3)."""
    return project_camera_points(intr, pw @ C + t.unsqueeze(-2))


def image_to_world_plane(intr: Intrinsics, C, t, p):
    """Backproject pixels (..., 2) to the world z=0 plane -> (..., 2) world xy.

    Normalizes pixels first and inverts only the O(1)-conditioned plane
    homography ``M = [[C0], [C1], [t]]`` (see the JAX twin for why).
    """
    dtype = p.dtype
    yn = (p[..., 1] - intr.cy) / intr.fy
    xn = (p[..., 0] - intr.cx - intr.skew * yn) / intr.fx
    ph = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    M = torch.cat([C[0:2, :], t[None, :]], dim=0)
    pw = ph @ torch.linalg.inv(M.to(dtype))
    return pw[..., 0:2] / pw[..., 2:3]


def pixel_to_unit_ray(intr: Intrinsics, p):
    """Pixels (..., 2) -> unit camera rays (..., 3); z = fx, as the reference."""
    x = p[..., 0] - intr.cx
    y = p[..., 1] - intr.cy
    z = torch.ones_like(x) * intr.fx
    return unit_rows(torch.stack([x, y, z], dim=-1))


def pixel_to_angle(intr: Intrinsics, p):
    """Pixels (..., 2) -> NED [elevation, azimuth] angles (..., 2)."""
    x = p[..., 0] - intr.cx
    y = p[..., 1] - intr.cy
    z = torch.ones_like(x) * intr.fx
    v_cam = torch.stack([x, y, z], dim=-1)
    v_ned = v_cam @ cam_to_ned_matrix(v_cam.dtype, v_cam.device).T
    return elevation_azimuth(v_ned)
