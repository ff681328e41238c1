"""The window gather that K2 (``slab_pallas``) and K3 (``patch_pallas``)
share, as ``csrc/window.cuh`` is their shared kernel: clamp N int32 corners
(x, y) into [0, W-size] x [0, H-size], then copy the (size, size) window of
an f32 image at each, points-major. Here are its plain version, the input
checks and the launch; each kernel's module keeps its own entry point,
plain version and launch counters.

A stack of V equal-sized images (V, H, W) is gathered in one call (the
lanes of ``run_batch``, K2 on the lanes engine and K3 on the fast one): the
N points are lane-major, point i reads image ``i // (N // V)``.
"""

from __future__ import annotations

import torch

from velocity_tpu_torch import cuda_build


def gather_ref(img, corners, size: int):
    """Plain version: clamp the corners in torch, then one advanced-index
    gather (from image i // (N // V) of a (V, H, W) stack). Returns
    (windows (N, size, size), clamped corners (N, 2) xy)."""
    H, W = img.shape[-2:]
    cx = torch.clamp(corners[:, 0], 0, W - size)
    cy = torch.clamp(corners[:, 1], 0, H - size)
    ar = torch.arange(size, device=img.device)
    rows = cy.long()[:, None] + ar[None, :]
    cols = cx.long()[:, None] + ar[None, :]
    if img.dim() == 2:
        win = img[rows[:, :, None], cols[:, None, :]]
    else:
        N = corners.shape[0]
        lane = torch.arange(N, device=img.device) // max(N // img.shape[0], 1)
        win = img[lane[:, None, None], rows[:, :, None], cols[:, None, :]]
    return win, torch.stack([cx, cy], dim=1)


def check(name: str, img, corners, size: int, stack: bool = False) -> None:
    """Raise ValueError unless ``img`` is a contiguous 2-D float32 tensor (or,
    with ``stack``, a 3-D stack of V images whose count divides N),
    ``corners`` a contiguous (N, 2) int32 tensor on its device, and the
    window fits the image."""
    dims = (2, 3) if stack else (2,)
    if img.dtype != torch.float32 or img.dim() not in dims or not img.is_contiguous():
        raise ValueError(f"{name}: img must be a contiguous {' or '.join(map(str, dims))}-D "
                         f"float32 tensor, got {img.dtype} {tuple(img.shape)}")
    if corners.device != img.device or corners.dtype != torch.int32 \
            or corners.dim() != 2 or corners.shape[1] != 2 or not corners.is_contiguous():
        raise ValueError(f"{name}: corners must be contiguous int32 (N, 2) on {img.device}, "
                         f"got {corners.dtype} {tuple(corners.shape)} on {corners.device}")
    H, W = img.shape[-2:]
    if not 0 < size <= min(H, W):
        raise ValueError(f"{name}: size {size} does not fit image {H}x{W}")
    if img.dim() == 3 and (img.shape[0] == 0 or corners.shape[0] % img.shape[0]):
        raise ValueError(f"{name}: {corners.shape[0]} corners do not split evenly over "
                         f"{img.shape[0]} images")


def launch(name: str, entry: str, img, corners, size: int, stack: bool = False):
    """Launch the C entry point ``entry`` on CUDA tensors (nothing for N = 0);
    returns (windows, clamped corners). With ``stack``, a 3-D ``img`` goes
    to the entry's ``_batched`` twin. Builds the kernels first if needed;
    raises where they cannot be built or the launch fails."""
    lib = cuda_build.library()
    check(name, img, corners, size, stack=stack)
    H, W = img.shape[-2:]
    N = corners.shape[0]
    out = torch.empty((N, size, size), dtype=torch.float32, device=img.device)
    cl = torch.empty((N, 2), dtype=torch.int32, device=img.device)
    if N == 0:
        return out, cl
    stream = torch.cuda.current_stream(img.device).cuda_stream
    if img.dim() == 2:
        rc = getattr(lib, entry)(img.data_ptr(), H, W, corners.data_ptr(), N, size,
                                 out.data_ptr(), cl.data_ptr(), stream)
    else:
        entry += "_batched"
        V = img.shape[0]
        rc = getattr(lib, entry)(img.data_ptr(), V, H, W, corners.data_ptr(), N, N // V,
                                 size, out.data_ptr(), cl.data_ptr(), stream)
    cuda_build.check(rc, entry)
    return out, cl
