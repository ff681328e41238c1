"""K3: batched patch extraction at clamped integer corners (CUDA), with its
plain twin.

Replaces ``velocity_tpu/ops/patch_pallas.py:extract_patches_pallas``; the
module keeps the JAX module's name. The TPU kernel clamps the corners in its
wrapper, scalar-prefetches them and issues one HBM->VMEM DMA per point. The
kernel here is ``csrc/patch.cu``, the window gather of ``csrc/window.cuh``
that K2 shares: a pure memory gather, bound by device-memory bytes, in
which each block reads and clamps its points' corners and copies their
windows with coalesced reads and stores. The TPU module's ``available()``
probe does not carry over: a CPU tensor takes the plain version, a CUDA
tensor launches K3 or raises.

JAX's ``run_batch`` with the fast backend vmaps the kernel over videos,
which gives its grid a lane axis; here a (V, H, W) image stack takes the
same single launch (``vt_extract_patches_batched``), the points lane-major,
point i from image i // (N // V).
"""

from __future__ import annotations

from velocity_tpu_torch.ops import window


def extract_patches_ref(img, corners, size: int):
    """Plain version: clamp the corners into [0, W-size] x [0, H-size], then
    one advanced-index gather (from image i // (N // V) of a (V, H, W)
    stack). Returns (patches (N, size, size), clamped corners (N, 2) xy)."""
    return window.gather_ref(img, corners, size)


def extract_patches(img, corners, size: int):
    """(N, size, size) f32 patches of ``img`` (H, W) at int32 ``corners``
    (N, 2) xy, clamped into the image; returns (patches, clamped corners).
    ``img`` may be a (V, H, W) stack whose count divides N: point i then
    reads image i // (N // V).

    A CPU ``img`` takes the plain version; a CUDA one launches K3 or raises.
    """
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"extract_patches: unsupported device {img.device}")
    if img.device.type == "cpu":
        window.check("extract_patches", img, corners, size, stack=True)
        return extract_patches_ref(img, corners, size)
    out, cl = window.launch("extract_patches", "vt_extract_patches", img, corners, size,
                            stack=True)
    if corners.shape[0]:
        extract_patches.launches += 1
        extract_patches.launches_by_shape[size] = \
            extract_patches.launches_by_shape.get(size, 0) + 1
    return out, cl


extract_patches.launches = 0
extract_patches.launches_by_shape = {}  # size -> launches
