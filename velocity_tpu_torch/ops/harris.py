"""Harris corners, top-k selection and subpixel refinement.

Torch twin of ``velocity_tpu/ops/harris.py``:
- ``harris_response``/``good_features`` <-> cv2.goodFeaturesToTrack with the
  Harris detector (blockSize 5, quality 0.01, minDistance 0): Sobel-3
  derivatives with OpenCV's 8-bit normalization, unnormalized reflect-101 box
  integration, R = det - k tr^2, 3x3 dilation NMS, quality threshold
  relative to the maximum, descending-response order.
- ``corner_subpix`` <-> cv2.cornerSubPix: the iterative gradient-weighted
  centroid solve with the Gaussian window, on one slab per point extracted
  by K2 and resampled by the tap stencil each iteration; on a card the
  whole loop is K4 (``csrc/subpix.cu``), whose plain twin is
  ``subpix_loop_ref``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from velocity_tpu_torch import cuda_build
from velocity_tpu_torch.ops.lk_lanes import _extract_slabs, _sample_taps


def _pad_reflect(img, r: int):
    return F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]


def _conv3(img, kx3):
    """3x3 convolution by shift-and-add, reflect-101 border."""
    H, W = img.shape
    p = _pad_reflect(img, 1)
    out = torch.zeros_like(img)
    for i in range(3):
        for j in range(3):
            k = kx3[i][j]
            if k != 0:
                out = out + k * p[i:i + H, j:j + W]
    return out


def sobel_xy(img, scale: float = 1.0):
    """Sobel-3 gradients with OpenCV kernel layout and optional scale."""
    KX = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
    KY = [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]
    return _conv3(img, KX) * scale, _conv3(img, KY) * scale


def _box_sum(img, block: int):
    """Unnormalized block x block box sum (reflect-101 border, cv2.boxFilter)."""
    H, W = img.shape
    r = block // 2
    p = _pad_reflect(img, r)
    out = torch.zeros_like(img)
    for i in range(block):
        out = out + p[i:i + H, r:r + W]
    p2 = _pad_reflect(out, r)
    out2 = torch.zeros_like(img)
    for j in range(block):
        out2 = out2 + p2[r:r + H, j:j + W]
    return out2


def harris_response(img, block: int = 5, k: float = 0.04, input_8u: bool = True):
    """Harris corner response map (cv2.cornerHarris semantics, ksize=3)."""
    x = img if img.is_floating_point() else img.to(torch.float32)
    scale = 1.0 / (4.0 * block)  # 2^(ksize-1) * block
    if input_8u:
        scale = scale / 255.0
    gx, gy = sobel_xy(x, scale)
    a = _box_sum(gx * gx, block)
    b = _box_sum(gx * gy, block)
    c = _box_sum(gy * gy, block)
    return a * c - b * b - k * (a + c) ** 2


class Corners(NamedTuple):
    points: torch.Tensor  # (max_corners, 2) xy, padded
    response: torch.Tensor  # (max_corners,)
    valid: torch.Tensor  # (max_corners,) bool


def good_features(img, max_corners: int = 1024, quality_level: float = 0.01,
                  block: int = 5, k: float = 0.04) -> Corners:
    """Top-``max_corners`` Harris corners after NMS and quality thresholding.

    Equal responses may come out in another order than ``lax.top_k``'s; the
    set of corners is the same.
    """
    R = harris_response(img, block=block, k=k)
    H, W = R.shape
    neg_inf = torch.tensor(-float("inf"), dtype=R.dtype, device=R.device)
    p = F.pad(R[None, None], (1, 1, 1, 1), mode="constant", value=-float("inf"))[0, 0]
    neigh = torch.stack([p[i:i + H, j:j + W] for i in range(3) for j in range(3)])
    is_peak = R >= torch.amax(neigh, dim=0)
    Rmax = torch.amax(R)
    keep = is_peak & (R > quality_level * Rmax)

    flatR = torch.where(keep, R, neg_inf).reshape(-1)
    vals, idx = torch.topk(flatR, max_corners)
    ys = torch.div(idx, W, rounding_mode="floor").to(R.dtype)
    xs = (idx % W).to(R.dtype)
    return Corners(points=torch.stack([xs, ys], dim=1), response=vals,
                   valid=torch.isfinite(vals))


def subpix_loop_ref(slabs, cl, pts, half_win: int, max_iters: int, eps: float):
    """Plain version of K4: the refinement loop on slabs that K2 extracted.

    ``slabs`` (N, Q, Q) at the clamped corners ``cl`` (N, 2) xy, seeds
    ``pts`` (N, 2) xy. Every iteration resamples each point's patch from its
    slab by the tap stencil, solves cv2's 2x2 system and moves the points
    that are not done; a point is done once its step is under ``eps``, its
    system is singular or it drifts past ``half_win + 1`` from its seed.
    The loop stops once every point is done; points that are done no longer
    move, so stopping early changes nothing. Returns (refined (N, 2), the
    iterations each point ran (N,) int32); their largest is the loop's trip
    count.
    """
    dtype = pts.dtype
    wsize = 2 * half_win + 1
    gsize = wsize + 2  # +1 ring for central differences
    drift_max = half_win + 1
    Q = slabs.shape[1]
    n_taps = Q - gsize + 1
    cl = cl.to(dtype)

    dev = pts.device
    off = torch.arange(wsize, dtype=dtype, device=dev) - half_win
    coef = 1.0 / (half_win * half_win)
    m1d = torch.exp(-(off * off) * coef)
    mask2d = (m1d[:, None] * m1d[None, :])[None]
    offx = off[None, None, :]
    offy = off[None, :, None]
    gh = (gsize - 1) * 0.5
    tiny16 = torch.finfo(dtype).tiny * 16

    q = pts
    done = torch.zeros(pts.shape[0], dtype=torch.bool, device=dev)
    iters = torch.zeros(pts.shape[0], dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        if bool(torch.all(done)):
            break
        iters += ~done
        ox = q[:, 0] - gh - cl[:, 0]
        oy = q[:, 1] - gh - cl[:, 1]
        patch = _sample_taps(slabs, oy, ox, gsize, n_taps)  # (N, gsize, gsize)
        gx = (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]) * 0.5
        gy = (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1]) * 0.5
        gxx = torch.sum(gx * gx * mask2d, dim=(1, 2))
        gxy = torch.sum(gx * gy * mask2d, dim=(1, 2))
        gyy = torch.sum(gy * gy * mask2d, dim=(1, 2))
        bx = torch.sum((gx * gx * offx + gx * gy * offy) * mask2d, dim=(1, 2))
        by = torch.sum((gx * gy * offx + gy * gy * offy) * mask2d, dim=(1, 2))
        det = gxx * gyy - gxy * gxy
        safe = torch.abs(det) > tiny16
        inv = torch.where(safe, 1.0 / det, torch.zeros_like(det))
        dx = (gyy * bx - gxy * by) * inv
        dy = (gxx * by - gxy * bx) * inv
        step = torch.stack([dx, dy], dim=1)
        blocked = done | ~safe
        q_new = torch.where(blocked[:, None], q, q + step)
        moved2 = torch.sum(step * step, dim=1)
        done = done | (moved2 < eps * eps) | ~safe
        # cv2 bails if the point drifts out of the window
        done = done | (torch.abs(q_new - pts) > drift_max).any(dim=1)
        q = q_new
    return q, iters


def _subpix_k4(slabs, cl, pts, half_win: int, max_iters: int, eps: float):
    """Launch K4 (``csrc/subpix.cu``) on CUDA tensors: ``subpix_loop_ref``'s
    result, each point's loop run on the card with no host read. Counts
    the launch on ``corner_subpix``."""
    N, Q, _ = slabs.shape
    dev = slabs.device
    for name, t, shape, dtype in (("slabs", slabs, (N, Q, Q), torch.float32),
                                  ("corners", cl, (N, 2), torch.int32),
                                  ("points", pts, (N, 2), torch.float32)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"corner_subpix: {name} must be contiguous {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    lib = cuda_build.library()
    out = torch.empty((N, 2), dtype=torch.float32, device=dev)
    iters = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return out, iters
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.vt_corner_subpix(slabs.data_ptr(), Q, cl.data_ptr(), pts.data_ptr(), N,
                              int(half_win), int(max_iters), float(eps * eps),
                              out.data_ptr(), iters.data_ptr(), stream)
    cuda_build.check(rc, "vt_corner_subpix")
    corner_subpix.launches += 1
    corner_subpix.launches_by_shape[Q] = corner_subpix.launches_by_shape.get(Q, 0) + 1
    return out, iters


def _subpix_slabs(img, pts, half_win: int):
    """The (N, Q, Q) slab of each point that its refinement resamples
    (K2 on a card), and the slabs' clamped corners (N, 2) xy: the patch
    and its ring of differences, wherever a drift of up to half_win + 1
    takes it."""
    gsize = 2 * half_win + 3
    drift_max = half_win + 1
    Q = gsize + 2 * (drift_max + 1)
    corner = torch.floor(pts).to(torch.int32) - gsize // 2 - drift_max - 1
    return _extract_slabs(img, corner, Q)


def _corner_subpix(img, points, half_win: int, max_iters: int, eps: float):
    """``corner_subpix`` with each point's iteration count: (refined (N, 2),
    iterations (N,) int32)."""
    dtype = points.dtype if points.is_floating_point() else torch.float32
    pts = points.to(dtype)
    slabs, cl = _subpix_slabs(img.to(dtype), pts, half_win)
    if pts.device.type == "cpu":
        return subpix_loop_ref(slabs, cl, pts, half_win, max_iters, eps)
    return _subpix_k4(slabs, cl, pts.contiguous(), half_win, max_iters, eps)


def corner_subpix(img, points, half_win: int = 5, max_iters: int = 100,
                  eps: float = 0.001):
    """Subpixel corner refinement (cv2.cornerSubPix, zeroZone=(-1,-1)).

    Corners drift at most ``half_win + 1`` px from their seed (cv2's bail
    out), so one (Q, Q) slab per point is extracted up front (K2) and every
    iteration resamples it. On a CPU tensor the plain loop refines them
    (``subpix_loop_ref``); on a CUDA one K2 then K4 (``csrc/subpix.cu``),
    which runs each point's whole loop on the card, or it raises.
    """
    return _corner_subpix(img, points, half_win, max_iters, eps)[0]


corner_subpix.launches = 0  # K4's
corner_subpix.launches_by_shape = {}  # slab size Q -> launches
