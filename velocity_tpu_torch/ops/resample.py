"""Separable image resampling as stencils (cv2 semantics).

Torch twin of ``velocity_tpu/ops/resample.py``. The JAX package writes these
as MXU matmuls with banded operator matrices, a TPU choice; on a GPU the
natural form is the separable stencil: pad, strided slices and adds, in
true f32 (no matmul, no cuDNN convolution, so TF32 cannot creep in).

- ``pyr_down``: cv2.pyrDown -- 5-tap [1,4,6,4,1]/16 Gaussian, reflect-101
  borders, decimation at even indices, output ((h+1)//2, (w+1)//2).
- ``resize_nearest``: cv2.resize INTER_NEAREST, src = min(floor(i/s), n-1).

Both take an image (H, W) or a stack of them (..., H, W), as JAX's vmap over
videos hands them one; each image of a stack gets the bits of its own call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_G5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _float(img):
    return img if img.is_floating_point() else img.to(torch.float32)


def _down_axis(xp, m: int, dim: int):
    """5-tap stencil at even centres along ``dim`` (-2 rows, -1 columns) of a
    reflect-padded array."""
    out = None
    for t, k in enumerate(_G5):
        sl = xp.narrow(dim, t, 2 * m - 1)
        sl = sl[..., ::2, :] if dim == -2 else sl[..., ::2]
        out = k * sl if out is None else out + k * sl
    return out


def pyr_down(img):
    """One Gaussian pyramid level down (cv2.pyrDown semantics) of an image
    (H, W) or a stack (..., H, W)."""
    x = _float(img)
    H, W = x.shape[-2:]
    h2, w2 = (H + 1) // 2, (W + 1) // 2
    xp = F.pad(x.reshape(-1, 1, H, W), (2, 2, 2, 2), mode="reflect")
    xp = xp.reshape(x.shape[:-2] + xp.shape[-2:])
    v = _down_axis(xp, h2, -2)  # vertical pass first, as the JAX R @ X @ C^T
    return _down_axis(v, w2, -1)


def resize_nearest(img, scale: float):
    """cv2.resize INTER_NEAREST with fx=fy=scale of an image (H, W) or a
    stack (..., H, W); keeps the input dtype."""
    H, W = img.shape[-2:]
    h = int(round(H * scale))
    w = int(round(W * scale))
    out = img.index_select(-2, _nearest_index(h, H, scale, img.device))
    return out.index_select(-1, _nearest_index(w, W, scale, img.device))


def _nearest_index(n: int, size: int, scale: float, device):
    """min(floor(arange(n) / scale), size - 1) as int64 on ``device``, in
    f64 as numpy computes it, made there without a host-to-device copy."""
    src = torch.floor(torch.arange(n, dtype=torch.float64, device=device) / scale)
    return torch.clamp(src.to(torch.int64), max=size - 1)
