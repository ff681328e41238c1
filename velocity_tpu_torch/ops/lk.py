"""The gather LK engine and what the LK engines share (torch twin of
``velocity_tpu/ops/lk.py``).

``lk_pyramidal`` replicates cv2.calcOpticalFlowPyrLK as a batched
computation: Scharr-smoothed gradients of the source window, fixed per
level; a 2x2 Gauss-Newton solve on the destination window, bilinearly
sampled from the image at every iteration; eps and oscillation stopping;
bounds and min-eigenvalue status. Affine maps on either image push the
sample grid through the map instead of warping the image, with the source
gradients chain-ruled through the map's linear part. Each level runs exactly
``iters`` iterations (the JAX ``fori_loop``), with no host sync. It is the
``lk_backend="reference"`` tracker backend and the oracle of the fast engine.

Also shared with the lanes and fast engines: ``LKResult``, the per-level
affine map and its per-point form, edge padding and the Scharr gradients of
a batch of patches.

Lanes (JAX's ``run_batch`` vmaps every engine over videos): the images may
be stacks (V, H, W) of equal-sized frames, the points then lie on one
lane-major axis of V*N (lane v's are rows v*N..v*N+N-1), and a warp may be
one (2, 3) map per lane, (V, 2, 3). Each sample reads its lane's image and
each point its lane's map; every per-point operation is the one of a single
call, so each lane gets the bits of its own call.

Units: gradients are in intensity per pixel; OpenCV's fixed-point
minEigThreshold (default 1e-4) is ``1024 * min_eig_threshold`` here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from velocity_tpu_torch.ops.interp import bilinear_sample
from velocity_tpu_torch.ops.pyramid import build_pyramid


class LKResult(NamedTuple):
    points: torch.Tensor  # (N, 2) tracked points (source-frame coords if warp_dst)
    status: torch.Tensor  # (N,) bool


def _affine_for_level(M, level, dtype):
    """Level-L sampling map: linear part unchanged, translation / 2^L (of a
    (2, 3) map or of each map of a stack (..., 2, 3))."""
    if M is None:
        return None
    M = M.to(dtype)
    s = 1.0 / (1 << level)
    return torch.cat([M[..., :2], M[..., 2:3] * s], dim=-1)


def _per_point(M, n_points: int):
    """A (2, 3) map as it is; a stack of one map per lane (V, 2, 3) as one
    per point (n_points, 2, 3), lane-major."""
    if M is None or M.dim() == 2:
        return M
    return M.repeat_interleave(n_points // M.shape[0], dim=0)


def _entry(M, i: int, j: int):
    """Entry (i, j) of a map against (N, rows, cols) grids: 0-d for one
    (2, 3) map, (N, 1, 1) for one map per point (N, 2, 3)."""
    return M[..., i, j] if M.dim() == 2 else M[:, i, j, None, None]


def _pad_edge(img, pad: int):
    """Edge-pad (H, W) ``img``, or each image of a stack (..., H, W), by
    ``pad`` on every side."""
    H, W = img.shape[-2:]
    out = F.pad(img.reshape(-1, 1, H, W), (pad, pad, pad, pad), mode="replicate")
    return out.reshape(img.shape[:-2] + out.shape[-2:])


def _grad_xy(patch):
    """Scharr-smoothed central-difference gradients of (N, H, W) patches
    ([3, 10, 3]/16 across, [-1, 0, 1]/2 along, replicate border)."""
    H, W = patch.shape[1:]
    p = F.pad(patch[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    rm, r0, rp = p[:, 0:H, 1:1 + W], p[:, 1:1 + H, 1:1 + W], p[:, 2:2 + H, 1:1 + W]
    sv = (3.0 * rm + 10.0 * r0 + 3.0 * rp) * (1.0 / 16.0)
    cm, c0, cp = p[:, 1:1 + H, 0:W], p[:, 1:1 + H, 1:1 + W], p[:, 1:1 + H, 2:2 + W]
    sh = (3.0 * cm + 10.0 * c0 + 3.0 * cp) * (1.0 / 16.0)
    pv = F.pad(sv[:, None], (1, 1, 0, 0), mode="replicate")[:, 0]
    gx = (pv[:, :, 2:2 + W] - pv[:, :, 0:W]) * 0.5
    ph = F.pad(sh[:, None], (0, 0, 1, 1), mode="replicate")[:, 0]
    gy = (ph[:, 2:2 + H] - ph[:, 0:H]) * 0.5
    return gx, gy


def scharr_derivatives(img):
    """Scharr-smoothed gradients (gx, gy) of an (H, W) image, or of each
    image of a stack (V, H, W), true units."""
    H, W = img.shape[-2:]
    gx, gy = _grad_xy(img.reshape(-1, H, W))
    return gx.reshape(img.shape), gy.reshape(img.shape)


def _apply_affine(M, x, y):
    """(x, y) through map M: one (2, 3) map, or one per point (N, 2, 3)
    against (N, rows, cols) grids."""
    if M is None:
        return x, y
    return (
        _entry(M, 0, 0) * x + _entry(M, 0, 1) * y + _entry(M, 0, 2),
        _entry(M, 1, 0) * x + _entry(M, 1, 1) * y + _entry(M, 1, 2),
    )


def _sample_grid(img, cx, cy, off, M, lane=None):
    """Sample the (N, W, W) window around centres (cx, cy) through map M
    (from image ``lane`` of a stack)."""
    gx = cx[:, None, None] + off[None, None, :]
    gy = cy[:, None, None] + off[None, :, None]
    sx, sy = _apply_affine(M, gx, gy)
    return bilinear_sample(img, sx, sy, lane=lane)


def _min_eig_gate(gxp, gyp, win: int, min_eig_threshold: float):
    """(a11, a12, a22, inv_det, eig_ok) of the source window's structure
    tensor; eig_ok applies OpenCV's min-eigenvalue gate and det > 0."""
    dtype = gxp.dtype
    a11 = torch.sum(gxp * gxp, dim=(1, 2))
    a12 = torch.sum(gxp * gyp, dim=(1, 2))
    a22 = torch.sum(gyp * gyp, dim=(1, 2))
    det = a11 * a22 - a12 * a12
    tr = a11 + a22
    min_eig = (tr - torch.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) * 0.5 / (win * win)
    eig_ok = (min_eig >= min_eig_threshold * 1024.0) & (det >= torch.finfo(dtype).tiny * 16)
    inv_det = torch.where(det != 0, 1.0 / det, torch.zeros_like(det))
    return a11, a12, a22, inv_det, eig_ok


def _in_bounds(pts, half: float, win: int, W: int, H: int):
    """OpenCV's window-corner bound: corner within [-win, size)."""
    inx = torch.floor(pts[:, 0] - half)
    iny = torch.floor(pts[:, 1] - half)
    return (inx >= -win) & (iny >= -win) & (inx < W) & (iny < H)


def _lk_update(j, npts, done, prev_delta, Jp, Ip, gxp, gyp, a11, a12, a22, inv_det,
               trackable, in_ok, eps2):
    """One Gauss-Newton update with eps and oscillation stopping (shared by
    the gather and fast engines). Returns (npts, done, prev_delta)."""
    diff = Jp - Ip
    b1 = torch.sum(diff * gxp, dim=(1, 2))
    b2 = torch.sum(diff * gyp, dim=(1, 2))
    # solve G delta = -b  (gradient from the source; OpenCV sign convention)
    dx = -(a22 * b1 - a12 * b2) * inv_det
    dy = -(a11 * b2 - a12 * b1) * inv_det
    delta = torch.stack([dx, dy], dim=1)

    active = (~done) & trackable & in_ok
    npts = torch.where(active[:, None], npts + delta, npts)
    small = torch.sum(delta * delta, dim=1) <= eps2
    # OpenCV oscillation damping: delta ~ -prev_delta -> back off half
    osc = (torch.abs(delta + prev_delta) < 0.01).all(dim=1) & (j > 0)
    npts = torch.where((active & osc)[:, None], npts - delta * 0.5, npts)
    done = done | small | osc | ~in_ok
    return npts, done, torch.where(active[:, None], delta, prev_delta)


def lk_pyramidal(
    src_img,
    dst_img,
    pts_src,
    guess=None,
    *,
    win: int = 15,
    max_level: int = 4,
    iters: int = 10,
    eps: float = 0.1,
    min_eig_threshold: float = 1e-4,
    warp_src=None,
    warp_dst=None,
) -> LKResult:
    """Track ``pts_src`` (N, 2) from ``src_img`` into ``dst_img`` (H, W).

    ``guess``: optional (N, 2) initial estimates (default ``pts_src``).
    ``warp_src`` / ``warp_dst``: optional (2, 3) affine sample maps at level-0
    scale; with ``warp_dst`` the solved coordinates live in the source frame.

    Lanes: images (V, H, W), ``pts_src`` and ``guess`` (V*N, 2) lane-major,
    each warp one (2, 3) map or one per lane (V, 2, 3).
    """
    dtype = pts_src.dtype if pts_src.is_floating_point() else torch.float32
    pts_src = pts_src.to(dtype)
    src_pyr = build_pyramid(src_img.to(dtype), max_level)
    dst_pyr = build_pyramid(dst_img.to(dtype), max_level)

    N = pts_src.shape[0]
    dev = pts_src.device
    half = (win - 1) * 0.5
    off = torch.arange(win, dtype=dtype, device=dev) - half
    eps2 = eps * eps

    next_pts = (guess if guess is not None else pts_src).to(dtype)
    next_pts = next_pts * (1.0 / (1 << max_level))
    status = torch.ones(N, dtype=torch.bool, device=dev)
    # each point's image in a stack, against (N, win, win) grids
    lane = (None if src_pyr[0].dim() == 2 else
            (torch.arange(N, device=dev) // (N // src_pyr[0].shape[0]))[:, None, None])

    for level in range(max_level, -1, -1):
        simg, dimg = src_pyr[level], dst_pyr[level]
        Hs, Ws = simg.shape[-2:]
        Hd, Wd = dimg.shape[-2:]
        Ms = _per_point(_affine_for_level(warp_src, level, dtype), N)
        Md = _per_point(_affine_for_level(warp_dst, level, dtype), N)
        p_l = pts_src * (1.0 / (1 << level))
        cx, cy = p_l[:, 0], p_l[:, 1]
        src_ok = _in_bounds(p_l, half, win, Ws, Hs)

        # fixed source window + gradient windows (chain rule through warp_src)
        patch_s = _sample_grid(simg, cx, cy, off, Ms, lane)
        sgx, sgy = scharr_derivatives(simg)
        gxp = _sample_grid(sgx, cx, cy, off, Ms, lane)
        gyp = _sample_grid(sgy, cx, cy, off, Ms, lane)
        if Ms is not None:
            gxp, gyp = (_entry(Ms, 0, 0) * gxp + _entry(Ms, 1, 0) * gyp,
                        _entry(Ms, 0, 1) * gxp + _entry(Ms, 1, 1) * gyp)

        a11, a12, a22, inv_det, eig_ok = _min_eig_gate(gxp, gyp, win, min_eig_threshold)
        trackable = src_ok & eig_ok
        if level == 0:
            status = status & trackable

        done = torch.zeros(N, dtype=torch.bool, device=dev)
        prev_delta = torch.zeros((N, 2), dtype=dtype, device=dev)
        for j in range(iters):
            in_ok = _in_bounds(next_pts, half, win, Wd, Hd)
            patch_d = _sample_grid(dimg, next_pts[:, 0], next_pts[:, 1], off, Md, lane)
            next_pts, done, prev_delta = _lk_update(
                j, next_pts, done, prev_delta, patch_d, patch_s, gxp, gyp,
                a11, a12, a22, inv_det, trackable, in_ok, eps2)

        if level == 0:
            status = status & _in_bounds(next_pts, half, win, Wd, Hd)
        else:
            next_pts = next_pts * 2.0

    return LKResult(points=next_pts, status=status)


def lk_forward_backward(
    src_img,
    dst_img,
    pts_src,
    *,
    fb_threshold: float | None = None,
    warp_dst=None,
    guess=None,
    **lk_kwargs,
) -> LKResult:
    """Forward LK plus an optional backward pass with forward-backward gating
    (the reference's cv2calcOpticalFlowPyrLK wrapper). The backward pass
    tracks the forward results back into the source image, with the warp
    on its source side; points whose round trip misses by ``fb_threshold``
    px or more are invalid. ``guess`` seeds only the forward pass."""
    fwd = lk_pyramidal(src_img, dst_img, pts_src, guess=guess,
                       warp_dst=warp_dst, **lk_kwargs)
    if fb_threshold is None:
        return fwd
    bwd = lk_pyramidal(dst_img, src_img, fwd.points, guess=fwd.points,
                       warp_src=warp_dst, **lk_kwargs)
    fbe = torch.sqrt(torch.sum((pts_src - bwd.points) ** 2, dim=1))
    ok = fwd.status & bwd.status & (fbe < fb_threshold)
    return LKResult(points=fwd.points, status=ok)
