"""K2: batched integer-corner slab extraction (CUDA), with its plain twin.

Replaces ``velocity_tpu/ops/slab_pallas.py:extract_slabs_dma``; the module
keeps the JAX module's name. The JAX caller (``lk_lanes._extract_slabs``)
clamps the corners, the kernel gathers, and the caller returns the clamped
corners. Here the kernel (``csrc/slab.cu``, the window gather of
``csrc/window.cuh``) does all three: it clamps each corner, writes the
clamped corners and copies the windows straight into the points-major
``(N, S, S)`` layout that the LK engine consumes (the JAX caller transposes
its ``(N, S, S)`` result to lanes-last ``(S, S, N)``; the port does not).

The TPU-only parts do not carry over: no (8, 128)-aligned padding, no
power-of-two scratch, no ``pltpu.roll``. Callers still edge-pad so that
in-bounds points never clamp (see ``lk_lanes._extract_slabs``).

JAX's ``run_batch`` vmaps the kernel over videos, which gives its grid a
lane axis; here a (V, H, W) image stack takes the same single launch
(``vt_extract_slabs_batched``), the points lane-major, point i from image
i // (N // V).
"""

from __future__ import annotations

from velocity_tpu_torch.ops import window


def extract_slabs_ref(img, corners, size: int):
    """Plain version: clamp the corners into [0, W-size] x [0, H-size], then
    one advanced-index gather (the twin of JAX's clip and vmapped
    ``dynamic_slice``, already in points-major order; from image
    i // (N // V) of a (V, H, W) stack). Returns (slabs (N, size, size),
    clamped corners (N, 2) xy)."""
    return window.gather_ref(img, corners, size)


def extract_slabs(img, corners, size: int):
    """(N, size, size) f32 slabs of ``img`` (H, W) at int32 ``corners``
    (N, 2) xy, clamped into the image; returns (slabs, clamped corners).
    ``img`` may be a (V, H, W) stack whose count divides N: point i then
    reads image i // (N // V).

    A CPU ``img`` takes the plain version; a CUDA one launches K2 or raises.
    """
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"extract_slabs: unsupported device {img.device}")
    if img.device.type == "cpu":
        window.check("extract_slabs", img, corners, size, stack=True)
        return extract_slabs_ref(img, corners, size)
    out, cl = window.launch("extract_slabs", "vt_extract_slabs", img, corners, size,
                            stack=True)
    if corners.shape[0]:
        extract_slabs.launches += 1
        extract_slabs.launches_by_shape[size] = extract_slabs.launches_by_shape.get(size, 0) + 1
    return out, cl


extract_slabs.launches = 0
extract_slabs.launches_by_shape = {}  # size -> launches
