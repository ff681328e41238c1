"""K3: batched patch extraction at clamped integer corners (CUDA), with its
plain twin.

Replaces ``velocity_tpu/ops/patch_pallas.py:extract_patches_pallas``; the
module keeps the JAX module's name. The TPU kernel clamps the corners in its
wrapper, scalar-prefetches them and issues one HBM->VMEM DMA per point. The
kernel here is ``csrc/patch.cu``: a pure memory gather, bound by
device-memory bytes, with one thread block per point that reads and clamps
its own corner and copies its window row by row, so that reads and writes
both coalesce. The TPU module's ``available()`` probe does not carry over:
a CPU tensor takes the plain version, a CUDA tensor launches K3 or raises.
"""

from __future__ import annotations

import torch

from velocity_tpu_torch import cuda_build


def _clamp_corners(corners, H: int, W: int, size: int):
    cx = torch.clamp(corners[:, 0], 0, W - size)
    cy = torch.clamp(corners[:, 1], 0, H - size)
    return torch.stack([cx, cy], dim=1)


def extract_patches_ref(img, corners, size: int):
    """Plain version: clamp the corners into [0, W-size] x [0, H-size], then
    one advanced-index gather. Returns (patches (N, size, size), clamped
    corners (N, 2) xy)."""
    H, W = img.shape
    cl = _clamp_corners(corners, H, W, size)
    ar = torch.arange(size, device=img.device)
    rows = cl[:, 1].long()[:, None] + ar[None, :]
    cols = cl[:, 0].long()[:, None] + ar[None, :]
    return img[rows[:, :, None], cols[:, None, :]], cl


def _check(img, corners, size: int):
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(f"extract_patches: img must be a contiguous 2-D float32 "
                         f"tensor, got {img.dtype} {tuple(img.shape)}")
    if corners.device != img.device or corners.dtype != torch.int32 \
            or corners.dim() != 2 or corners.shape[1] != 2 or not corners.is_contiguous():
        raise ValueError(f"extract_patches: corners must be contiguous int32 (N, 2) on "
                         f"{img.device}, got {corners.dtype} {tuple(corners.shape)} "
                         f"on {corners.device}")
    H, W = img.shape
    if not 0 < size <= min(H, W):
        raise ValueError(f"extract_patches: size {size} does not fit image {H}x{W}")


def extract_patches(img, corners, size: int):
    """(N, size, size) f32 patches of ``img`` (H, W) at int32 ``corners``
    (N, 2) xy, clamped into the image; returns (patches, clamped corners).

    A CPU ``img`` takes the plain version; a CUDA one launches K3 or raises.
    """
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"extract_patches: unsupported device {img.device}")
    if img.device.type == "cpu":
        _check(img, corners, size)
        return extract_patches_ref(img, corners, size)
    lib = cuda_build.library()
    _check(img, corners, size)
    H, W = img.shape
    N = corners.shape[0]
    out = torch.empty((N, size, size), dtype=torch.float32, device=img.device)
    cl = torch.empty((N, 2), dtype=torch.int32, device=img.device)
    if N == 0:
        return out, cl
    stream = torch.cuda.current_stream(img.device).cuda_stream
    rc = lib.vt_extract_patches(img.data_ptr(), H, W, corners.data_ptr(), N, size,
                                out.data_ptr(), cl.data_ptr(), stream)
    cuda_build.check(rc, "vt_extract_patches")
    extract_patches.launches += 1
    return out, cl


extract_patches.launches = 0
