"""Linear pose initializers (torch twin of ``velocity_tpu/solvers/linear_init.py``).

- ``planar_pose``: the reference's ``extrinsicsPlanar``, a DLT homography
  from plane points to pixels, then R from the first two homography columns
  orthogonalized by SVD, t from the third.
- ``rotation_lsq``: the reference's ``fcnLS_R``, the least-squares rotation
  aligning world directions to pixel rays, SVD-projected onto SO(3).
"""

from __future__ import annotations

import torch

from velocity_tpu_torch.geometry.norms import unit_rows
from velocity_tpu_torch.geometry.projection import Intrinsics, pixel_to_unit_ray


def _hartley_normalizer(p):
    """(3, 3) similarity that centres ``p`` (N, 2) and scales its mean
    distance from the centre to sqrt(2)."""
    mu = torch.mean(p, dim=0)
    scale = 2.0 ** 0.5 / torch.clamp(torch.mean(torch.linalg.norm(p - mu, dim=1)), min=1e-12)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    return torch.stack([
        torch.stack([scale, zero, -scale * mu[0]]),
        torch.stack([zero, scale, -scale * mu[1]]),
        torch.stack([zero, zero, one]),
    ])


def dlt_homography(src, dst):
    """Least-squares planar homography H (3x3): dst ~ normalize([src 1] @ H^T).

    src: (N, 2) plane points; dst: (N, 2) pixels; N >= 4. Row-vector DLT with
    Hartley normalization for conditioning.
    """
    Ts, Td = _hartley_normalizer(src), _hartley_normalizer(dst)
    ones = torch.ones((src.shape[0], 1), dtype=src.dtype, device=src.device)
    sh = torch.cat([src, ones], dim=1) @ Ts.T
    dh = torch.cat([dst, ones], dim=1) @ Td.T

    x, y = sh[:, 0], sh[:, 1]
    u, v = dh[:, 0], dh[:, 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_u = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=1)
    rows_v = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=1)
    A = torch.cat([rows_u, rows_v], dim=0)
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    Hn = Vt[-1].reshape(3, 3)
    H = torch.linalg.inv(Td) @ Hn @ Ts
    return H / H[2, 2]


def planar_pose(intr: Intrinsics, pixels, plane_pts):
    """Closed-form pose from >=4 coplanar correspondences (z=0 plane).

    Returns (R, t) in the row-vector convention
    (``pixels ~ project(plane3 @ R + t)``).
    """
    dtype = pixels.dtype
    H = dlt_homography(plane_pts[:, 0:2].to(dtype), pixels)
    # column-convention decomposition: x_pix_h ~ K_col @ [r1 r2 t] [X Y 1]^T
    fx, fy, cx, cy, skew = (torch.as_tensor(v, dtype=dtype, device=pixels.device)
                            for v in intr)
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    K_col = torch.stack([
        torch.stack([fx, skew, cx]),
        torch.stack([zero, fy, cy]),
        torch.stack([zero, zero, one]),
    ])
    B = torch.linalg.solve(K_col, H)
    lam = 1.0 / torch.linalg.norm(B[:, 0])
    # enforce positive depth (plane in front of the camera)
    lam = torch.where(B[2, 2] * lam > 0, lam, -lam)
    r1 = B[:, 0] * lam
    r2 = B[:, 1] * lam
    r3 = torch.linalg.cross(r1, r2)
    Rc = torch.stack([r1, r2, r3], dim=1)  # columns
    U, _, Vt = torch.linalg.svd(Rc)
    Rc = U @ Vt
    t = B[:, 2] * lam
    # column-convention X_cam = Rc @ X_w + t  ->  row convention x @ Rc^T + t
    return Rc.T, t


def rotation_lsq(intr: Intrinsics, pixels, world_pts):
    """Least-squares rotation: pixel rays ~ unit(world_pts) @ R, SVD-projected."""
    z = pixel_to_unit_ray(intr, pixels)
    Hm = unit_rows(world_pts)
    R = torch.linalg.solve(Hm.T @ Hm, Hm.T @ z)
    U, _, Vt = torch.linalg.svd(R)
    return U @ Vt
