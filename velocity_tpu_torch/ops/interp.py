"""Bilinear sampling and patch gathering (torch twin of ``velocity_tpu/ops/interp.py``).

The gather primitives of the gather LK engine (``ops/lk.py``), the dense
warp (``ops/warp.py``) and the fast LK engine (``ops/lk_fast.py``):

- ``bilinear_sample``: cv2.remap INTER_LINEAR semantics, borders "clamp"
  (replicate) and "zero", of one image or, with a lane per sample, of a
  stack;
- ``gather_patches`` / ``affine_grid_patches``: bilinear windows around
  points, optionally through an affine map;
- ``extract_patches``: integer-corner windows through K3
  (``ops/patch_pallas.py``), the one irregular access of the fast engine;
- ``sample_patches``: fractional resampling of whole patches as two batched
  matrix products ``S_y @ patch @ S_x^T`` (Catmull-Rom or linear weights).

Sampling keeps the JAX package's own border and alignment rules; it is not
``F.grid_sample``, whose rules differ.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from velocity_tpu_torch.ops import patch_pallas


def bilinear_sample(img, x, y, border: str = "clamp", lane=None):
    """Sample (H, W) ``img`` at float coordinates (x, y), bilinearly.

    ``x``, ``y`` broadcast together; pixel units with the origin at pixel
    centres (cv2.remap INTER_LINEAR). ``border="clamp"`` replicates edges,
    ``"zero"`` returns 0 outside [0, W-1] x [0, H-1]. ``img`` may be a stack
    (V, H, W) of equal-sized images; ``lane`` (int64, broadcasting with x
    and y) then names each sample's image, as JAX's vmap over videos samples
    each lane's own frame.
    """
    H, W = img.shape[-2:]
    if (img.dim() == 3) != (lane is not None):
        raise ValueError(f"bilinear_sample: a lane index goes with an image stack, got "
                         f"img {tuple(img.shape)} and lane {lane is not None}")
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    ax = x - x0
    ay = y - y0

    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)

    at = () if lane is None else (lane,)
    v00 = img[at + (y0i, x0i)]
    v01 = img[at + (y0i, x1i)]
    v10 = img[at + (y1i, x0i)]
    v11 = img[at + (y1i, x1i)]

    out = (
        v00 * (1 - ax) * (1 - ay)
        + v01 * ax * (1 - ay)
        + v10 * (1 - ax) * ay
        + v11 * ax * ay
    )
    if border == "zero":
        inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
        out = torch.where(inside, out, torch.zeros_like(out))
    return out


def _patch_offsets(size: int, dtype, device=None):
    """(size,) window offsets centred at 0: j - (size-1)/2."""
    return torch.arange(size, dtype=dtype, device=device) - (size - 1) * 0.5


def gather_patches(img, centers, size: int, border: str = "clamp"):
    """(N, size, size) bilinear patches centred at ``centers`` (N, 2) xy."""
    off = _patch_offsets(size, centers.dtype, centers.device)
    x = centers[:, 0, None, None] + off[None, None, :]
    y = centers[:, 1, None, None] + off[None, :, None]
    return bilinear_sample(img, x, y, border)


def affine_grid_patches(img, centers, size: int, M, border: str = "clamp"):
    """Patches whose window grid around ``centers`` (source coordinates) is
    sampled from ``img`` at ``M[:, :2] @ g + M[:, 2]`` (M is 2x3)."""
    off = _patch_offsets(size, centers.dtype, centers.device)
    gx = centers[:, 0, None, None] + off[None, None, :]
    gy = centers[:, 1, None, None] + off[None, :, None]
    x = M[0, 0] * gx + M[0, 1] * gy + M[0, 2]
    y = M[1, 0] * gx + M[1, 1] * gy + M[1, 2]
    return bilinear_sample(img, x, y, border)


def extract_patches(img, corners, size: int):
    """(N, size, size) pixel patches at integer ``corners`` (N, 2) xy, clamped.

    ``img`` is one image (H, W) or, lane-major, a stack (V, H, W): point i
    then reads image i // (N // V). Images smaller than the patch are
    edge-padded (bottom and right) first, each image of a stack as alone.
    The extraction is K3 (``patch_pallas.extract_patches``), which clamps
    the corners into the image. Returns (patches in ``img``'s dtype, clamped
    corners (N, 2) int32 xy).
    """
    H, W = img.shape[-2:]
    if H < size or W < size:
        pad = F.pad(img.reshape(-1, 1, H, W), (0, max(0, size - W), 0, max(0, size - H)),
                    mode="replicate")
        img = pad.reshape(img.shape[:-2] + pad.shape[-2:])
    patches, cl = patch_pallas.extract_patches(
        img.to(torch.float32).contiguous(), corners.to(torch.int32).contiguous(), size)
    return patches.to(img.dtype), cl


def _sep_weights(offset, out_size: int, in_size: int, cubic: bool):
    """(..., out_size, in_size) interpolation weights for samples at
    ``j + offset`` along one axis, positions clipped to the patch."""
    j = torch.arange(out_size, dtype=offset.dtype, device=offset.device)
    k = torch.arange(in_size, dtype=offset.dtype, device=offset.device)
    pos = torch.clamp(j[:, None] + offset[..., None, None], 0.0, in_size - 1.0)
    d = torch.abs(k - pos)
    if not cubic:
        return torch.clamp(1.0 - d, min=0.0)
    # Catmull-Rom (Keys a=-0.5), renormalised over the clipped support
    w1 = (1.5 * d - 2.5) * d * d + 1.0  # |d| < 1
    w2 = ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0  # 1 <= |d| < 2
    w = torch.where(d < 1.0, w1, torch.where(d < 2.0, w2, torch.zeros_like(d)))
    return w / torch.sum(w, dim=-1, keepdim=True)


def sample_patches(patches, dy, dx, out_size: int, cubic: bool = False):
    """Resample (N, P, P) patches at fractional offsets (dy, dx) (N,) into
    (N, out_size, out_size), as ``S_y @ patch @ S_x^T``. ``cubic`` selects
    Catmull-Rom weights, for patches that are themselves interpolated."""
    Sy = _sep_weights(dy, out_size, patches.shape[-2], cubic)
    Sx = _sep_weights(dx, out_size, patches.shape[-1], cubic)
    return torch.bmm(torch.bmm(Sy, patches), Sx.transpose(1, 2))
