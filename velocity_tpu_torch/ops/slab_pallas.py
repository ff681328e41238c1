"""K2: batched integer-corner slab extraction (CUDA), with its plain twin.

Replaces ``velocity_tpu/ops/slab_pallas.py:extract_slabs_dma``; the module
keeps the JAX module's name. The kernel is ``csrc/slab.cu``: a pure memory
gather, bound by device-memory bytes, written as one thread block per point
with coalesced row reads and writes straight into the points-major
``(N, S, S)`` layout that the LK engine consumes (the JAX caller transposes
its ``(N, S, S)`` result to lanes-last ``(S, S, N)``; the port does not).

The TPU-only parts do not carry over: no (8, 128)-aligned padding, no
power-of-two scratch, no ``pltpu.roll``. Callers still edge-pad so that
in-bounds points never clamp (see ``lk_lanes._extract_slabs``).
"""

from __future__ import annotations

import torch

from velocity_tpu_torch import cuda_build


def extract_slabs_ref(img, cx, cy, size: int):
    """Plain version: (N, size, size) slabs ``img[cy:cy+size, cx:cx+size]``
    by one advanced-index gather (the twin of the JAX vmapped
    ``dynamic_slice``, already in points-major order)."""
    ar = torch.arange(size, device=img.device)
    rows = cy.long()[:, None] + ar[None, :]
    cols = cx.long()[:, None] + ar[None, :]
    return img[rows[:, :, None], cols[:, None, :]]


def extract_slabs(img, cx, cy, size: int):
    """(N, size, size) f32 slabs at integer corners (cx, cy) of ``img``.

    Corners must be pre-clamped into [0, W-size] x [0, H-size]. A CPU
    ``img`` takes the plain version; a CUDA one launches K2 or raises.
    """
    if img.device.type == "cpu":
        return extract_slabs_ref(img, cx, cy, size)
    if img.device.type != "cuda":
        raise ValueError(f"extract_slabs: unsupported device {img.device}")
    lib = cuda_build.library()
    H, W = img.shape
    N = cx.shape[0]
    if img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError("extract_slabs: img must be contiguous float32")
    for name, v in (("cx", cx), ("cy", cy)):
        if v.device != img.device or v.dtype != torch.int32 or v.shape != (N,) \
                or not v.is_contiguous():
            raise ValueError(f"extract_slabs: {name} must be contiguous int32 (N,) "
                             f"on {img.device}")
    if size > H or size > W:
        raise ValueError(f"extract_slabs: size {size} exceeds image {H}x{W}")
    out = torch.empty((N, size, size), dtype=torch.float32, device=img.device)
    if N == 0:
        return out
    stream = torch.cuda.current_stream(img.device).cuda_stream
    rc = lib.vt_extract_slabs(img.data_ptr(), H, W, cx.data_ptr(), cy.data_ptr(),
                              N, size, out.data_ptr(), stream)
    cuda_build.check(rc, "vt_extract_slabs")
    extract_slabs.launches += 1
    return out


extract_slabs.launches = 0
