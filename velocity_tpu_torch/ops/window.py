"""The window gather that K2 (``slab_pallas``) and K3 (``patch_pallas``)
share, as ``csrc/window.cuh`` is their shared kernel: clamp N int32 corners
(x, y) into [0, W-size] x [0, H-size], then copy the (size, size) window of
an f32 image at each, points-major. Here are its plain version, the input
checks and the launch; each kernel's module keeps its own entry point,
plain version and launch counters.
"""

from __future__ import annotations

import torch

from velocity_tpu_torch import cuda_build


def gather_ref(img, corners, size: int):
    """Plain version: clamp the corners in torch, then one advanced-index
    gather. Returns (windows (N, size, size), clamped corners (N, 2) xy)."""
    H, W = img.shape
    cx = torch.clamp(corners[:, 0], 0, W - size)
    cy = torch.clamp(corners[:, 1], 0, H - size)
    ar = torch.arange(size, device=img.device)
    rows = cy.long()[:, None] + ar[None, :]
    cols = cx.long()[:, None] + ar[None, :]
    return img[rows[:, :, None], cols[:, None, :]], torch.stack([cx, cy], dim=1)


def check(name: str, img, corners, size: int) -> None:
    """Raise ValueError unless ``img`` is a contiguous 2-D float32 tensor,
    ``corners`` a contiguous (N, 2) int32 tensor on its device, and the
    window fits the image."""
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(f"{name}: img must be a contiguous 2-D float32 tensor, "
                         f"got {img.dtype} {tuple(img.shape)}")
    if corners.device != img.device or corners.dtype != torch.int32 \
            or corners.dim() != 2 or corners.shape[1] != 2 or not corners.is_contiguous():
        raise ValueError(f"{name}: corners must be contiguous int32 (N, 2) on {img.device}, "
                         f"got {corners.dtype} {tuple(corners.shape)} on {corners.device}")
    H, W = img.shape
    if not 0 < size <= min(H, W):
        raise ValueError(f"{name}: size {size} does not fit image {H}x{W}")


def launch(name: str, entry: str, img, corners, size: int):
    """Launch the C entry point ``entry`` on CUDA tensors (nothing for N = 0);
    returns (windows, clamped corners). Builds the kernels first if needed;
    raises where they cannot be built or the launch fails."""
    lib = cuda_build.library()
    check(name, img, corners, size)
    H, W = img.shape
    N = corners.shape[0]
    out = torch.empty((N, size, size), dtype=torch.float32, device=img.device)
    cl = torch.empty((N, 2), dtype=torch.int32, device=img.device)
    if N == 0:
        return out, cl
    stream = torch.cuda.current_stream(img.device).cuda_stream
    rc = getattr(lib, entry)(img.data_ptr(), H, W, corners.data_ptr(), N, size,
                             out.data_ptr(), cl.data_ptr(), stream)
    cuda_build.check(rc, entry)
    return out, cl
