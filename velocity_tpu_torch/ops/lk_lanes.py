"""The lanes LK engine, points-major (torch twin of ``velocity_tpu/ops/lk_lanes.py``).

Same algorithm as the JAX engine, which matches cv2.calcOpticalFlowPyrLK:
Scharr-smoothed gradients of the source window, iterations in blocks of
BLOCK_ITERS that re-extract the destination slab at the current estimates
(so a point can travel arbitrarily far), eps and oscillation stopping,
min-eigenvalue and bounds status gates, and the stage-3 affine warp of the
destination (or, on the backward leg, of the source) by a separable two-pass
stencil.

The JAX engine puts the point axis last, on the TPU's 128 lanes. Here every
patch tensor is points-major, ``(N, P, P)``: one point's slab is contiguous,
which is what a thread block per point reads. Public functions keep JAX's
layouts (points ``(N, 2)``). Two kernel hooks sit where the JAX engine
calls Pallas: ``_extract_slabs`` (K2) and the block update in
``_level_loop`` (K1). Two more stand where the JAX engine leaves the work
to XLA's fusion: ``_extract_warped_lanes`` (K5, ``csrc/warp_window.cu``),
the warped windows, and ``source_window`` (K6, ``csrc/source_window.cu``),
each level's source window.

JAX's ``run_batch`` vmaps this engine over videos. Here the lanes of a batch
are written out: the images are stacks (V, H, W) of equal-sized frames, the
points lie on one lane-major axis of V*N (lane v's are rows v*N..v*N+N-1),
and an affine map may be one (2, 3) per lane, (V, 2, 3). K2 then gathers
every lane's windows in one launch, K1 updates every lane's points in one,
and the early exit of ``_level_loop`` reads one flag for all lanes. Every
per-point operation is the one of a single call, and a block in which a
lane has no active point leaves that lane's points as they are, so each
lane gets the bits of its own call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from velocity_tpu_torch import cuda_build
from velocity_tpu_torch.ops.lk import (LKResult, _affine_for_level, _grad_xy, _pad_edge,
                                       _per_point)
from velocity_tpu_torch.ops.lk_block_pallas import (  # noqa: F401
    BLOCK_ITERS,
    REACH,
    _sample_taps,
    _w_linear,
    block_iters_ref,
    lk_block,
)
from velocity_tpu_torch.ops.pyramid import build_pyramid
from velocity_tpu_torch.ops.slab_pallas import extract_slabs
from velocity_tpu_torch.utils.loops import fixed_trips

# Tap count of the warped-extraction stencil (see the JAX twin).
WARP_TAPS = 8


def _round8(x: int) -> int:
    return (x + 7) & ~7


def _extract_slabs(img, corners, size: int):
    """(N, size, size) integer-corner slabs, points-major, through K2, from
    an image (H, W) or, lane-major, from a stack (V, H, W).

    Corners (N, 2) int32 xy clamp into the image (inside K2). Returns
    (slabs, clamped corners (N, 2) xy). Callers edge-pad ``img`` (and offset
    ``corners`` by the pad) so that in-bounds points never clamp: a clamped
    corner shifts the slab content relative to the stencil anchor and
    corrupts every sample.
    """
    H, W = img.shape[-2:]
    if H < size or W < size:
        pad = F.pad(img.reshape(-1, 1, H, W), (0, max(0, size - W), 0, max(0, size - H)),
                    mode="replicate")
        img = pad.reshape(img.shape[:-2] + pad.shape[-2:])
    return extract_slabs(img.contiguous(), corners, size)


def _extract_warped_lanes_ref(imgp, pad: int, centers, P: int, M, oo: int):
    """Plain version of ``_extract_warped_lanes`` (K5's twin): (N, P, P)
    patches of the (pre-padded) image sampled through affine M.

    The destination grid for output (i, j) of point n is
    ``centers[:, n] + (j - oo, i - oo)``. Bilinear interpolation factors into
    an x-pass per source row and a y-pass, each a WARP_TAPS-tap stencil over
    one axis-aligned slab per point (see the JAX twin for the derivation).
    ``imgp`` must be edge-padded by ``pad`` >= slab size; it may be a stack
    (V, H, W), and M one map (2, 3) or one per point (N, 2, 3). Returns
    (patches, fractional window corner (2, N)).
    """
    dtype = centers.dtype
    dev = centers.device
    cx, cy = centers[0], centers[1]

    def m(i, j):  # entry (i, j) of the map: 0-d, or (N,) per point
        return M[..., i, j]

    def e(c):  # a 0-d or per-point coefficient against (N, rows, cols) grids
        return c[..., None, None]

    base_x = m(0, 0) * cx + m(0, 1) * cy + m(0, 2)
    base_y = m(1, 0) * cx + m(1, 1) * cy + m(1, 2)
    ms = WARP_TAPS // 2 - 1
    Q = _round8(P + WARP_TAPS)

    kx = torch.floor(base_x).to(torch.int32) - oo - ms + pad
    ky = torch.floor(base_y).to(torch.int32) - oo - ms + pad
    slab, K = _extract_slabs(imgp, torch.stack([kx, ky], dim=1), Q)  # (N, Q, Q)
    bx_s = base_x + float(pad) - K[:, 0].to(dtype)  # slab coords of the centre's image
    by_s = base_y + float(pad) - K[:, 1].to(dtype)

    idx = torch.arange(P, dtype=dtype, device=dev)
    joff = (idx - oo)[None, None, :]  # centred dest column offsets
    ioff = (idx - oo)[None, :, None]
    jj = idx[None, None, :]
    ii = idx[None, :, None]
    # near-identity precondition: the x-pass solves the dest row through M11
    m11 = m(1, 1)
    inv_m11 = torch.where(torch.abs(m11) > 1e-3, 1.0 / m11, torch.ones_like(m11))

    # x-pass positions (N, Q, P), relative to the identity slab column j
    yy = torch.arange(Q, dtype=dtype, device=dev)[None, :, None]
    ex = (
        bx_s[:, None, None]
        + e(m(0, 0)) * joff
        + e(m(0, 1) * inv_m11) * (yy - by_s[:, None, None] - e(m(1, 0)) * joff)
        - jj
    )
    ex = torch.clamp(ex, 0.0, WARP_TAPS - 1.0)
    H = None
    for dx in range(WARP_TAPS):
        w = _w_linear(ex - dx)
        sl = slab[:, :, dx:dx + P]
        H = w * sl if H is None else H + w * sl

    # y-pass positions (N, P, P), relative to the identity row i
    ey = by_s[:, None, None] + e(m(1, 0)) * joff + e(m11) * ioff - ii
    ey = torch.clamp(ey, 0.0, WARP_TAPS - 1.0)
    out = None
    for dy in range(WARP_TAPS):
        w = _w_linear(ey - dy)
        sl = H[:, dy:dy + P, :]
        out = w * sl if out is None else out + w * sl

    corner = torch.stack([cx - oo, cy - oo], dim=0)
    return out, corner


def _extract_warped_lanes(imgp, pad: int, centers, P: int, M, oo: int):
    """(N, P, P) patches of the (pre-padded) image sampled through affine M,
    and the fractional window corner (2, N); arguments as
    ``_extract_warped_lanes_ref``'s.

    CPU tensors take the plain version; CUDA ones launch K5
    (``csrc/warp_window.cu``: the corners, the slab and both passes of
    every point in one kernel, the plain version's bits) or raise.
    """
    if centers.device.type == "cpu":
        return _extract_warped_lanes_ref(imgp, pad, centers, P, M, oo)
    return extract_warped(imgp, pad, centers, P, M, oo)


def extract_warped(imgp, pad: int, centers, P: int, M, oo: int):
    """K5's wrapper: launch it on CUDA tensors and count the launch in its
    ``launches`` and ``launches_by_shape`` ((P, Q) -> launches). Raises
    ValueError on inputs K5 does not take (a dtype other than float32,
    centres not (2, N), a map neither (2, 3) nor one per point, a
    non-contiguous image or map, an image smaller than the slab, a device
    other than one CUDA device)."""
    Q = _round8(P + WARP_TAPS)
    if centers.dtype != torch.float32 or centers.dim() != 2 or centers.shape[0] != 2:
        raise ValueError(f"extract_warped: centers must be float32 (2, N), got "
                         f"{centers.dtype} {tuple(centers.shape)}")
    N = centers.shape[1]
    if imgp.dtype != torch.float32 or imgp.dim() not in (2, 3) or not imgp.is_contiguous():
        raise ValueError(f"extract_warped: imgp must be a contiguous float32 (H, W) or "
                         f"(V, H, W), got {imgp.dtype} {tuple(imgp.shape)}")
    if M.dtype != torch.float32 or tuple(M.shape) not in ((2, 3), (N, 2, 3)) \
            or not M.is_contiguous():
        raise ValueError(f"extract_warped: M must be a contiguous float32 (2, 3) or "
                         f"({N}, 2, 3), got {M.dtype} {tuple(M.shape)}")
    H, W = imgp.shape[-2:]
    V = imgp.shape[0] if imgp.dim() == 3 else 1
    if Q > min(H, W) or V == 0 or N % V:
        raise ValueError(f"extract_warped: {N} points on {V} images of {H}x{W} "
                         f"(slab {Q})")
    dev = centers.device
    if dev.type != "cuda" or imgp.device != dev or M.device != dev:
        raise ValueError(f"extract_warped: unsupported device {dev} (image on "
                         f"{imgp.device}, map on {M.device})")
    out = torch.empty((N, P, P), dtype=torch.float32, device=dev)
    corner = torch.empty((2, N), dtype=torch.float32, device=dev)
    if N == 0:
        return out, corner
    lib = cuda_build.library()
    rc = lib.vt_extract_warped(imgp.data_ptr(), V, H, W, pad, centers.data_ptr(),
                               centers.stride(0), centers.stride(1), M.data_ptr(),
                               6 if M.dim() == 3 else 0, N, P, Q, oo, out.data_ptr(),
                               corner.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "vt_extract_warped")
    extract_warped.launches += 1
    extract_warped.launches_by_shape[(P, Q)] = extract_warped.launches_by_shape.get((P, Q), 0) + 1
    return out, corner


extract_warped.launches = 0
extract_warped.launches_by_shape = {}  # (P, Q) -> launches

SRC_MARGIN = 2  # gradient + bilinear support around the source window


def _source_window_ref(simg, p_l, win: int, min_eig_threshold: float, Ms=None):
    """Plain version of ``source_window`` (K6's twin): one level's source
    window of every point, fixed for the level's iterations.

    ``simg`` is the level (H, W), or a stack (V, H, W) lane-major; ``p_l``
    (2, N) the points at the level's scale; ``Ms`` None (an integer-corner
    slab through K2, sampled with the linear stencil) or the backward leg's
    source map, one (2, 3) or one per point (the slab warped through it by
    K5, sampled with the cubic stencil). Returns (Ip, gxp, gyp (N, win,
    win), a11, a12, a22, inv_det (N,), trackable (N,) bool): the window,
    its Scharr gradients, its structure tensor and its min-eigenvalue and
    bounds gate.
    """
    dtype = p_l.dtype
    dev = p_l.device
    Hs, Ws = simg.shape[-2:]
    half = (win - 1) * 0.5
    eig_thresh = torch.full((), min_eig_threshold * 1024.0, dtype=dtype, device=dev)
    tiny16 = torch.full((), torch.finfo(dtype).tiny * 16, dtype=dtype, device=dev)
    cx, cy = p_l[0], p_l[1]

    src_ok = (
        (torch.floor(cx - half) >= -win) & (torch.floor(cy - half) >= -win)
        & (torch.floor(cx - half) < Ws) & (torch.floor(cy - half) < Hs)
    )

    # ---- source window: one extraction, fixed fractional sample ----
    if Ms is None:
        Ps = _round8(win + 2 * SRC_MARGIN + 1)
        simgp = _pad_edge(simg, Ps)  # no-clamp guarantee (see _extract_slabs)
        ci = torch.floor(p_l).to(torch.int32)
        corners = torch.stack([ci[0] - (win - 1) // 2 - SRC_MARGIN + Ps,
                               ci[1] - (win - 1) // 2 - SRC_MARGIN + Ps], dim=1)
        spatch, scorner = _extract_slabs(simgp, corners, Ps)
        su = cx - half - (scorner[:, 0] - Ps).to(dtype)
        sv = cy - half - (scorner[:, 1] - Ps).to(dtype)
        s_taps, s_cubic = SRC_MARGIN + 2, False
    else:
        oo_s = (win - 1) // 2 + REACH + 1
        Psw = _round8(win + 2 * REACH + 3)
        Qs = _round8(Psw + WARP_TAPS)
        simgp = _pad_edge(simg, Qs)
        spatch, scorner2 = _extract_warped_lanes(simgp, Qs, p_l, Psw, Ms, oo_s)
        su = cx - half - scorner2[0]
        sv = cy - half - scorner2[1]
        s_taps, s_cubic = REACH + 4, True  # fixed offset o0 = REACH+1
    sgx, sgy = _grad_xy(spatch)
    Ip = _sample_taps(spatch, sv, su, win, s_taps, cubic=s_cubic)
    gxp = _sample_taps(sgx, sv, su, win, s_taps, cubic=s_cubic)
    gyp = _sample_taps(sgy, sv, su, win, s_taps, cubic=s_cubic)

    a11 = torch.sum(gxp * gxp, dim=(1, 2))
    a12 = torch.sum(gxp * gyp, dim=(1, 2))
    a22 = torch.sum(gyp * gyp, dim=(1, 2))
    det = a11 * a22 - a12 * a12
    tr = a11 + a22
    min_eig = (tr - torch.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) * 0.5 / (win * win)
    eig_ok = (min_eig >= eig_thresh) & (det >= tiny16)
    trackable = src_ok & eig_ok
    inv_det = torch.where(det != 0, 1.0 / det, torch.zeros_like(det))
    return Ip, gxp, gyp, a11, a12, a22, inv_det, trackable


def source_window(simg, p_l, win: int, min_eig_threshold: float, Ms=None):
    """One level's source window of every point; arguments and results as
    ``_source_window_ref``'s.

    CPU tensors take the plain version. CUDA ones edge-pad the level, run
    K5 first where ``Ms`` is given, and launch K6 (``csrc/source_window.cu``:
    the slab, its gradients, the three samplings and the gate of every point
    in one kernel; Ip, gxp and gyp are the plain version's bits, the sums
    the same up to their order), counted in ``launches`` and
    ``launches_by_shape`` ((win, P, cubic) -> launches). Raises ValueError
    on inputs K6 does not take (a dtype other than float32, points not
    (2, N), an empty level or one whose stack does not split the points, a
    device other than one CUDA device).
    """
    dev = p_l.device
    if dev.type == "cpu":
        return _source_window_ref(simg, p_l, win, min_eig_threshold, Ms)
    if p_l.dtype != torch.float32 or p_l.dim() != 2 or p_l.shape[0] != 2:
        raise ValueError(f"source_window: points must be float32 (2, N), got {p_l.dtype} "
                         f"{tuple(p_l.shape)}")
    N = p_l.shape[1]
    if simg.dtype != torch.float32 or simg.dim() not in (2, 3):
        raise ValueError(f"source_window: the level must be a float32 (H, W) or (V, H, W), "
                         f"got {simg.dtype} {tuple(simg.shape)}")
    Hs, Ws = simg.shape[-2:]
    V = simg.shape[0] if simg.dim() == 3 else 1
    if min(Hs, Ws) < 1 or V == 0 or N % V:
        raise ValueError(f"source_window: {N} points on {V} images of {Hs}x{Ws}")
    if dev.type != "cuda" or simg.device != dev or (Ms is not None and Ms.device != dev):
        raise ValueError(f"source_window: unsupported device {dev} (level on {simg.device})")
    cubic = Ms is not None
    if cubic:
        oo = (win - 1) // 2 + REACH + 1
        P = _round8(win + 2 * REACH + 3)
        Q = _round8(P + WARP_TAPS)
        src, corner = _extract_warped_lanes(_pad_edge(simg, Q), Q, p_l, P, Ms, oo)
        n_taps, shift = REACH + 4, 0
    else:
        P = _round8(win + 2 * SRC_MARGIN + 1)
        src, corner = _pad_edge(simg, P), None
        n_taps, shift = SRC_MARGIN + 2, P - (win - 1) // 2 - SRC_MARGIN
    windows = torch.empty((3, N, win, win), dtype=torch.float32, device=dev)
    sums = torch.empty((4, N), dtype=torch.float32, device=dev)
    trackable = torch.empty((N,), dtype=torch.bool, device=dev)
    if N:
        H, W = src.shape[-2:]
        rc = cuda_build.library().vt_source_window(
            src.data_ptr(), V, H, W, None if corner is None else corner.data_ptr(),
            p_l.data_ptr(), p_l.stride(0), p_l.stride(1), N, win, P, n_taps, int(cubic), shift,
            min_eig_threshold * 1024.0, Hs, Ws, windows.data_ptr(), sums.data_ptr(),
            trackable.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(rc, "vt_source_window")
        source_window.launches += 1
        key = (win, P, cubic)
        source_window.launches_by_shape[key] = source_window.launches_by_shape.get(key, 0) + 1
    return (windows[0], windows[1], windows[2], sums[0], sums[1], sums[2], sums[3], trackable)


source_window.launches = 0
source_window.launches_by_shape = {}  # (win, P, cubic) -> launches


def _level_loop(
    dimg,
    pts0,  # (2, N) current estimates at this level's scale
    trackable,
    Ip,
    gxp,
    gyp,
    a11,
    a12,
    a22,
    inv_det,
    *,
    win: int,
    iters: int,
    eps: float,
    warp=None,
    dtype=torch.float32,
):
    """Blocked LK iteration loop, shared by plain and warped destinations.

    Each block (re)extracts destination patches anchored at the current
    estimates, then runs BLOCK_ITERS updates (K1). Run eagerly, the loop
    exits once no trackable point is left undone (one host read per
    block), as JAX's ``while_loop`` does; the blocks it skips would change
    nothing, since only active (trackable, not done) points move. Where the
    step is captured (``utils/loops.py``) every block of the level runs,
    ceil(iters / BLOCK_ITERS) of them, with no host read. With a stack
    ``dimg`` (V, H, W) the loop runs while any lane has such a point;
    ``warp`` is then one map per point.
    """
    N = pts0.shape[1]
    Hd, Wd = dimg.shape[-2:]
    cubic = warp is not None
    if cubic:
        oo = (win - 1) // 2 + REACH + 1  # anchor offset o0 = REACH+1, range +-REACH
        P = _round8(win + 2 * REACH + 3)
        n_taps = 2 * REACH + 4
        Q = _round8(P + WARP_TAPS)
        imgp = _pad_edge(dimg, Q)
    else:
        margin = REACH  # o0 = REACH + frac, range ~ +-REACH
        P = _round8(win + 2 * REACH + 1)
        n_taps = 2 * REACH + 2
        # edge-pad once per level so corner clamping can never shift slab
        # content off the stencil anchor: every point inside the in_ok bound
        # lands fully inside the padded image
        dimgp = _pad_edge(dimg, P)
    n_blocks = max(1, -(-iters // BLOCK_ITERS))

    pts = pts0.contiguous()
    done = torch.zeros(N, dtype=torch.bool, device=pts.device)
    prev_delta = torch.zeros((2, N), dtype=dtype, device=pts.device)
    fixed = fixed_trips()
    for blk in range(n_blocks):
        if not fixed and not bool(torch.any(trackable & ~done)):
            break
        if warp is None:
            ci = torch.floor(pts).to(torch.int32)
            corners = torch.stack([ci[0] - (win - 1) // 2 - margin + P,
                                   ci[1] - (win - 1) // 2 - margin + P], dim=1)
            dpatch, dcorner = _extract_slabs(dimgp, corners, P)
            bx = (P - dcorner[:, 0]).to(dtype).contiguous()  # image corner = dcorner - P
            by = (P - dcorner[:, 1]).to(dtype).contiguous()
        else:
            dpatch, corner = _extract_warped_lanes(imgp, Q, pts, P, warp, oo)
            bx = (-corner[0]).contiguous()
            by = (-corner[1]).contiguous()
        pts, done, prev_delta = lk_block(
            dpatch.contiguous(), Ip, gxp, gyp, a11, a12, a22, inv_det, bx, by,
            trackable, pts, done, prev_delta, blk * BLOCK_ITERS,
            win=win, n_taps=n_taps, cubic=cubic, eps=eps, Wd=Wd, Hd=Hd,
        )
    return pts


def lk_pyramidal_lanes(
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
    warp_dst=None,
    warp_src=None,
    src_pyr=None,
    dst_pyr=None,
) -> LKResult:
    """Pyramidal LK of ``pts_src`` (N, 2) from ``src_img`` into ``dst_img``.

    ``warp_dst`` samples destination patches through the affine (stage-3
    fine tracking); ``warp_src`` warps the source side instead (the backward
    leg of forward-backward gating with a warp). ``src_pyr``/``dst_pyr``:
    prebuilt pyramids (>= max_level+1 levels), built once per frame.

    Lanes: images (V, H, W), ``pts_src`` and ``guess`` (V*N, 2) lane-major,
    each warp one (2, 3) map or one per lane (V, 2, 3).
    """
    dtype = pts_src.dtype if pts_src.is_floating_point() else torch.float32
    pts_src = pts_src.to(dtype)
    if src_pyr is None:
        src_pyr = build_pyramid(src_img.to(dtype), max_level)
    if dst_pyr is None:
        dst_pyr = build_pyramid(dst_img.to(dtype), max_level)

    N = pts_src.shape[0]
    dev = pts_src.device
    half = (win - 1) * 0.5

    ptsT = pts_src.T  # (2, N)
    cur = (guess if guess is not None else pts_src).to(dtype).T
    cur = cur * (1.0 / (1 << max_level))
    status = torch.ones(N, dtype=torch.bool, device=dev)

    for level in range(max_level, -1, -1):
        simg, dimg = src_pyr[level], dst_pyr[level]
        scale = 1.0 / (1 << level)
        Md = _per_point(_affine_for_level(warp_dst, level, dtype), N)
        Ms = _per_point(_affine_for_level(warp_src, level, dtype), N)
        p_l = ptsT * scale
        Ip, gxp, gyp, a11, a12, a22, inv_det, trackable = source_window(
            simg, p_l, win, min_eig_threshold, Ms)
        if level == 0:
            status = status & trackable

        cur = _level_loop(
            dimg, cur, trackable, Ip, gxp, gyp, a11, a12, a22, inv_det,
            win=win, iters=iters, eps=eps, warp=Md, dtype=dtype,
        )

        if level == 0:
            Hd, Wd = dimg.shape[-2:]
            inx = torch.floor(cur[0] - half)
            iny = torch.floor(cur[1] - half)
            status = status & (inx >= -win) & (iny >= -win) & (inx < Wd) & (iny < Hd)
        else:
            cur = cur * 2.0

    return LKResult(points=cur.T, status=status)


def lk_forward_backward_lanes(
    src_img, dst_img, pts_src, *, fb_threshold=None, warp_dst=None, guess=None,
    src_pyr=None, dst_pyr=None, **kw
) -> LKResult:
    """Forward + backward LK with forward-backward gating. With a
    destination warp, the backward leg warps its *source* side, so both legs
    live in source-frame coordinates."""
    fwd = lk_pyramidal_lanes(src_img, dst_img, pts_src, guess=guess,
                             warp_dst=warp_dst, src_pyr=src_pyr,
                             dst_pyr=dst_pyr, **kw)
    if fb_threshold is None:
        return fwd
    if warp_dst is None:
        bwd = lk_pyramidal_lanes(dst_img, src_img, fwd.points, guess=fwd.points,
                                 src_pyr=dst_pyr, dst_pyr=src_pyr, **kw)
    else:
        bwd = lk_pyramidal_lanes(dst_img, src_img, fwd.points, guess=fwd.points,
                                 warp_src=warp_dst, src_pyr=dst_pyr,
                                 dst_pyr=src_pyr, **kw)
    fbe = torch.sqrt(torch.sum((pts_src - bwd.points) ** 2, dim=1))
    ok = fwd.status & bwd.status & (fbe < fb_threshold)
    return LKResult(points=fwd.points, status=ok)
