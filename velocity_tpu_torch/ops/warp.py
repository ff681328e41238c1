"""Dense affine warping, cv2.remap style (torch twin of ``velocity_tpu/ops/warp.py``).

For tests and the exact two-interpolation replication of the reference's
warp-then-track; the tracker fuses the warp into LK sampling instead.
"""

from __future__ import annotations

import torch

from velocity_tpu_torch.ops.interp import bilinear_sample


def affine_warp(img, M, out_shape, offset=(0.0, 0.0), border: str = "zero"):
    """out(i, j) = img(M @ [j + ox, i + oy, 1]) with bilinear sampling.

    ``offset`` shifts the output grid origin (the reference warps ROI grids
    starting at (x0, y0)).
    """
    H, W = out_shape
    dtype = torch.promote_types(img.dtype, torch.float32)
    ox, oy = offset
    xs = torch.arange(W, dtype=dtype, device=img.device) + ox
    ys = torch.arange(H, dtype=dtype, device=img.device) + oy
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    M = M.to(dtype)
    sx = M[0, 0] * gx + M[0, 1] * gy + M[0, 2]
    sy = M[1, 0] * gx + M[1, 1] * gy + M[1, 2]
    return bilinear_sample(img.to(dtype), sx, sy, border=border)
