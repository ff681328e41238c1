"""Image pyramids (torch twin of ``velocity_tpu/ops/pyramid.py``)."""

from __future__ import annotations

from velocity_tpu_torch.ops.resample import _float, pyr_down, resize_nearest  # noqa: F401


def build_pyramid(img, max_level: int):
    """List of ``max_level + 1`` float images; level 0 is the input (an
    image (H, W) or a stack (V, H, W), whose every level is then a stack)."""
    levels = [_float(img)]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1]))
    return levels
