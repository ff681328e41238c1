"""The fast LK engine: patches extracted once per level, iterations as batched
matrix products (torch twin of ``velocity_tpu/ops/lk_fast.py``).

The gather engine (``ops/lk.py``) bilinear-samples the destination image at
every iteration. This engine restructures LK:

  1. Per level, extract one padded patch per point from each image, the only
     irregular memory access: axis-aligned patches through K3
     (``interp.extract_patches``); affine-warped destination patches once
     per phase, as a 12x12-tap stencil over one K3 slab per point.
  2. Sampling at a fractional offset (dy, dx) becomes
     ``S_y(dy) @ patch @ S_x(dx)^T`` with small interpolation-weight
     matrices (``interp.sample_patches``), so each iteration is two batched
     products plus reductions.

Semantics match ``ops/lk.py`` (gradients, eps and oscillation stopping,
min-eigenvalue and bounds status) with one documented deviation: each
point's search per level is bounded by ``search_radius`` px around its
initial estimate (samples clamp at the patch edge beyond that). Every level
runs exactly ``iters`` iterations, with no host sync.

Lanes (JAX's ``run_batch`` vmaps the engine over videos): the images may be
stacks (V, H, W) of equal-sized frames, the points one lane-major axis of
V*N, and a warp one (2, 3) map per lane, (V, 2, 3). K3 then extracts every
lane's patches in one launch from the stack (point i from image
i // (N // V)), the resampling stays one batched product over all V*N
points, and each lane gets the bits of its own call.
"""

from __future__ import annotations

import torch

from velocity_tpu_torch.ops.interp import extract_patches as _extract_axis_aligned
from velocity_tpu_torch.ops.interp import sample_patches as _sample
from velocity_tpu_torch.ops.lk import (
    LKResult,
    _affine_for_level,
    _entry,
    _grad_xy,
    _in_bounds,
    _lk_update,
    _min_eig_gate,
    _pad_edge,
    _per_point,
)
from velocity_tpu_torch.ops.pyramid import build_pyramid

# Stencil width of the warped extraction: per-pixel source positions may
# deviate from the identity grid by up to (taps/2 - 2) px before clamping.
# The warps are one-frame affine priors (|scale-1| usually < 2e-2), so
# deviations across a ~70 px patch stay under 2 px; 12 taps cover scale
# factors out to ~1.05.
WARP_STENCIL_TAPS = 12


def _extract_warped(img, centers, size: int, M):
    """(N, size, size) patches of ``img`` sampled through affine M on a grid
    anchored at the exact fractional ``centers`` (N, 2).

    Because M is near-identity, the bilinear gather is a stencil: one
    axis-aligned slab per point (K3), then a taps x taps weighted sum of
    shifted slab slices (dy outer, dx inner, as in JAX). ``img`` may be a
    stack (V, H, W) with lane-major centres, M one (2, 3) map or one per
    point (N, 2, 3). Returns (patches, fractional window corner (N, 2))."""
    dtype = centers.dtype
    dev = centers.device
    half = (size - 1) // 2
    taps = WARP_STENCIL_TAPS
    margin = taps // 2 - 1
    Q = size + taps  # slab side: shifts 0..taps-1 of a size-wide slice

    def m(i, j):  # entry (i, j) of the map: 0-d, or (N,) per point
        return M[..., i, j]

    corner = centers - half
    # source position of the patch centre (the stencil's anchor)
    base_x = m(0, 0) * centers[:, 0] + m(0, 1) * centers[:, 1] + m(0, 2)
    base_y = m(1, 0) * centers[:, 0] + m(1, 1) * centers[:, 1] + m(1, 2)
    offc = torch.arange(size, dtype=dtype, device=dev) - half
    # (i=row, j=col) offsets through the linear part: (size, size), or
    # (N, size, size) with one map per point
    Gx = _entry(M, 0, 0) * offc[None, :] + _entry(M, 0, 1) * offc[:, None]
    Gy = _entry(M, 1, 0) * offc[None, :] + _entry(M, 1, 1) * offc[:, None]

    # edge-pad so that slab corners never clamp: a clamped corner would shift
    # the slab off the stencil's anchor
    pad = Q
    imgp = _pad_edge(img, pad)
    kx = torch.floor(base_x - half).to(torch.int32) - margin + pad
    ky = torch.floor(base_y - half).to(torch.int32) - margin + pad
    slab, K = _extract_axis_aligned(imgp, torch.stack([kx, ky], dim=1), Q)

    # sample positions in slab coordinates, relative to the identity grid
    # (i, j), clipped to the stencil's reach
    ii = torch.arange(size, dtype=dtype, device=dev)[:, None]
    jj = torch.arange(size, dtype=dtype, device=dev)[None, :]
    ey = torch.clamp((base_y + pad - K[:, 1].to(dtype))[:, None, None] + Gy - ii,
                     0.0, taps - 2.0)
    ex = torch.clamp((base_x + pad - K[:, 0].to(dtype))[:, None, None] + Gx - jj,
                     0.0, taps - 2.0)

    wxs = [torch.clamp(1.0 - torch.abs(ex - dx), min=0.0) for dx in range(taps)]
    out = torch.zeros((centers.shape[0], size, size), dtype=slab.dtype, device=dev)
    for dy in range(taps):
        wy = torch.clamp(1.0 - torch.abs(ey - dy), min=0.0)
        for dx in range(taps):
            out = out + (wy * wxs[dx]) * slab[:, dy:dy + size, dx:dx + size]
    return out, corner


def _source_window(spatch, sv, su, win: int, cubic: bool):
    """(Ip, gxp, gyp): the source window and its gradients, sampled from the
    extracted source patch at the fixed fractional offset (sv, su)."""
    sgx, sgy = _grad_xy(spatch)
    return (_sample(spatch, sv, su, win, cubic=cubic),
            _sample(sgx, sv, su, win, cubic=cubic),
            _sample(sgy, sv, su, win, cubic=cubic))


def _iterate(n_iters, npts, anchor, dpatch, base_x, base_y, cubic, Ip, gxp, gyp,
             a11, a12, a22, inv_det, trackable, *, half, win, Wd, Hd, eps2):
    """``n_iters`` LK updates against a destination patch; ``base_x/base_y``
    place the patch's window origin. With an ``anchor`` (the estimate the
    patch was extracted at), the offset is written as the anchor's plus the
    motion since, as the JAX engine writes it; without one, from ``npts``."""
    N = npts.shape[0]
    done = torch.zeros(N, dtype=torch.bool, device=npts.device)
    prev_delta = torch.zeros((N, 2), dtype=npts.dtype, device=npts.device)
    for j in range(n_iters):
        if anchor is None:
            ox = npts[:, 0] - half + base_x
            oy = npts[:, 1] - half + base_y
        else:
            d = npts - anchor
            ox = anchor[:, 0] - half + base_x + d[:, 0]
            oy = anchor[:, 1] - half + base_y + d[:, 1]
        Jp = _sample(dpatch, oy, ox, win, cubic=cubic)
        in_ok = _in_bounds(npts, half, win, Wd, Hd)
        npts, done, prev_delta = _lk_update(
            j, npts, done, prev_delta, Jp, Ip, gxp, gyp, a11, a12, a22, inv_det,
            trackable, in_ok, eps2)
    return npts


def lk_pyramidal_fast(
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
    search_radius: int = 8,
    warp_dst=None,
) -> LKResult:
    """Fast equivalent of ``ops.lk.lk_pyramidal`` (see the deviation note).

    Lanes: images (V, H, W), ``pts_src`` and ``guess`` (V*N, 2) lane-major,
    ``warp_dst`` one (2, 3) map or one per lane (V, 2, 3)."""
    dtype = pts_src.dtype if pts_src.is_floating_point() else torch.float32
    pts_src = pts_src.to(dtype)
    src_pyr = build_pyramid(src_img.to(dtype), max_level)
    dst_pyr = build_pyramid(dst_img.to(dtype), max_level)

    N = pts_src.shape[0]
    half = (win - 1) * 0.5
    R = search_radius
    P = win + 2 * R + 3  # window + search + bilinear/gradient margins
    kw = dict(half=half, win=win, eps2=eps * eps)

    next_pts = (guess if guess is not None else pts_src).to(dtype)
    next_pts = next_pts * (1.0 / (1 << max_level))
    status = torch.ones(N, dtype=torch.bool, device=pts_src.device)

    for level in range(max_level, -1, -1):
        simg, dimg = src_pyr[level], dst_pyr[level]
        Hs, Ws = simg.shape[-2:]
        Hd, Wd = dimg.shape[-2:]
        Md = _per_point(_affine_for_level(warp_dst, level, dtype), N)
        p_l = pts_src * (1.0 / (1 << level))
        src_ok = _in_bounds(p_l, half, win, Ws, Hs)

        # ---- one source patch and its gradients per level ----
        corner_f = torch.floor(p_l).to(torch.int32) - (win - 1) // 2 - R - 1
        spatch, scorner = _extract_axis_aligned(simg, corner_f, P)
        su = p_l[:, 0] - half - scorner[:, 0].to(dtype)
        sv = p_l[:, 1] - half - scorner[:, 1].to(dtype)
        Ip, gxp, gyp = _source_window(spatch, sv, su, win, cubic=False)

        a11, a12, a22, inv_det, eig_ok = _min_eig_gate(gxp, gyp, win, min_eig_threshold)
        trackable = src_ok & eig_ok
        if level == 0:
            status = status & trackable
        consts = (Ip, gxp, gyp, a11, a12, a22, inv_det, trackable)

        # ---- destination patches anchored at the current estimate ----
        # Axis-aligned patches are exact pixels: one phase. Warped patches
        # are interpolated, so the grid is anchored at the exact fractional
        # estimate and a second, shorter phase re-extracts after convergence
        # to remove the first phase's en-route bias.
        if Md is None:
            anchor = next_pts
            dcorner_i = torch.floor(anchor).to(torch.int32) - (win - 1) // 2 - R - 1
            dpatch, dcorner = _extract_axis_aligned(dimg, dcorner_i, P)
            next_pts = _iterate(iters, next_pts, anchor, dpatch, -dcorner[:, 0].to(dtype),
                                -dcorner[:, 1].to(dtype), False, *consts,
                                Wd=Wd, Hd=Hd, **kw)
        else:
            for phase_iters in (iters, max(2, iters // 4)):
                anchor = next_pts
                dpatch, dcorner = _extract_warped(dimg, anchor, P, Md)
                next_pts = _iterate(phase_iters, next_pts, anchor, dpatch, -dcorner[:, 0],
                                    -dcorner[:, 1], True, *consts, Wd=Wd, Hd=Hd, **kw)

        if level == 0:
            status = status & _in_bounds(next_pts, half, win, Wd, Hd)
        else:
            next_pts = next_pts * 2.0

    return LKResult(points=next_pts, status=status)


def lk_forward_backward_fast(
    src_img, dst_img, pts_src, *, fb_threshold=None, warp_dst=None, guess=None, **kw
) -> LKResult:
    """Fast forward + backward LK with forward-backward gating
    (``ops.lk.lk_forward_backward`` semantics). With a destination warp the
    backward pass samples its source (the destination image) through the
    warp. ``guess`` seeds only the forward pass."""
    fwd = lk_pyramidal_fast(src_img, dst_img, pts_src, guess=guess,
                            warp_dst=warp_dst, **kw)
    if fb_threshold is None:
        return fwd
    if warp_dst is None:
        bwd = lk_pyramidal_fast(dst_img, src_img, fwd.points, guess=fwd.points, **kw)
    else:
        bwd = _lk_backward_warped(dst_img, src_img, fwd.points, warp_dst, **kw)
    fbe = torch.sqrt(torch.sum((pts_src - bwd.points) ** 2, dim=1))
    ok = fwd.status & bwd.status & (fbe < fb_threshold)
    return LKResult(points=fwd.points, status=ok)


def _lk_backward_warped(
    wimg,  # destination image (sampled through the warp = backward source)
    dst_img,  # original source image (backward destination)
    pts,  # forward results (source-frame coordinates)
    M,  # (2, 3) affine, source -> wimg coordinates (or one per lane, (V, 2, 3))
    *,
    win: int = 15,
    max_level: int = 4,
    iters: int = 10,
    eps: float = 0.1,
    min_eig_threshold: float = 1e-4,
    search_radius: int = 8,
) -> LKResult:
    """Backward pass whose *source* patches come through the warp."""
    dtype = pts.dtype if pts.is_floating_point() else torch.float32
    pts = pts.to(dtype)
    src_pyr = build_pyramid(wimg.to(dtype), max_level)
    dst_pyr = build_pyramid(dst_img.to(dtype), max_level)

    N = pts.shape[0]
    half = (win - 1) * 0.5
    R = search_radius
    P = win + 2 * R + 3
    kw = dict(half=half, win=win, eps2=eps * eps)

    next_pts = pts * (1.0 / (1 << max_level))
    status = torch.ones(N, dtype=torch.bool, device=pts.device)

    for level in range(max_level, -1, -1):
        simg, dimg = src_pyr[level], dst_pyr[level]
        Hd, Wd = dimg.shape[-2:]
        Ml = _per_point(_affine_for_level(M, level, dtype), N)
        p_l = pts * (1.0 / (1 << level))

        # warped source patch: its numeric gradients are already with respect
        # to the source-frame coordinates, so no chain rule follows
        spatch, scorner = _extract_warped(simg, p_l, P, Ml)
        su = p_l[:, 0] - half - scorner[:, 0]
        sv = p_l[:, 1] - half - scorner[:, 1]
        Ip, gxp, gyp = _source_window(spatch, sv, su, win, cubic=True)

        a11, a12, a22, inv_det, trackable = _min_eig_gate(gxp, gyp, win, min_eig_threshold)
        if level == 0:
            status = status & trackable

        dci = torch.floor(next_pts).to(torch.int32) - (win - 1) // 2 - R - 1
        dpatch, dcorner = _extract_axis_aligned(dimg, dci, P)
        next_pts = _iterate(iters, next_pts, None, dpatch, -dcorner[:, 0].to(dtype),
                            -dcorner[:, 1].to(dtype), False, Ip, gxp, gyp, a11, a12, a22,
                            inv_det, trackable, Wd=Wd, Hd=Hd, **kw)

        if level == 0:
            status = status & _in_bounds(next_pts, half, win, Wd, Hd)
        else:
            next_pts = next_pts * 2.0

    return LKResult(points=next_pts, status=status)
