"""K1: one fused LK iteration block (CUDA), with its plain twin.

Replaces ``velocity_tpu/ops/lk_block_pallas.py:lk_block``; the module keeps
the JAX module's name. The kernel is ``csrc/lk_block.cu``: per update it
evaluates only the taps that weigh (2 linear, 4 cubic) from the slab held
in shared memory, with each thread's gradient strip in registers, and
reduces straight into b = sum((J - I) * grad) without storing the sampled
window. Windows up to 16 run one warp per point, larger ones one block per
point; see the source for what bounds it.

Layouts are points-major, the natural Hopper form (one block reads one
contiguous slab): dpatch (N, P, P), Ip/gxp/gyp (N, win, win), per-point
vectors (N,), pts/prev_delta (2, N); the masks are bool, which the kernel
reads and writes as bytes. The TPU's lane blocking (``BN=1024/128``) and
the ``N % 128`` precondition do not carry over.

``block_iters_ref`` is the plain version: the torch twin of
``velocity_tpu/ops/lk_lanes.py:block_iters_ref``. ``lk_block`` takes it for
CPU tensors and launches K1 for CUDA tensors.
"""

from __future__ import annotations

import torch

from velocity_tpu_torch import cuda_build

BLOCK_ITERS = 5  # must match csrc/lk_block.cu
REACH = 3


def _w_linear(a):
    return torch.clamp(1.0 - torch.abs(a), min=0.0)


def _w_cubic(a):
    """Catmull-Rom (Keys a=-0.5) kernel on |d|."""
    d = torch.abs(a)
    w1 = (1.5 * d - 2.5) * d * d + 1.0
    w2 = ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0
    return torch.where(d < 1.0, w1, torch.where(d < 2.0, w2, torch.zeros_like(d)))


def _sample_taps(patch, oy, ox, win: int, n_taps: int, cubic: bool = False):
    """(N, win, win) window of (N, P, P) ``patch`` at per-point offsets.

    ``oy, ox``: (N,) fractional window-start offsets into the patch. Two-pass
    weighted sum of shifted slices; offsets clip to the stencil's range
    (linear: [0, n_taps-1]; cubic: [1, n_taps-2]).
    """
    P = patch.shape[1]
    n_taps = min(n_taps, P - win + 1)
    lo, hi = (1.0, float(n_taps - 2)) if cubic else (0.0, float(n_taps - 1))
    oy = torch.clamp(oy, lo, max(hi, lo))
    ox = torch.clamp(ox, lo, max(hi, lo))
    w_fn = _w_cubic if cubic else _w_linear

    H = None
    for dx in range(n_taps):
        wx = w_fn(ox - dx)[:, None, None]
        sl = patch[:, :, dx:dx + win]
        H = wx * sl if H is None else H + wx * sl
    out = None
    for dy in range(n_taps):
        wy = w_fn(oy - dy)[:, None, None]
        sl = H[:, dy:dy + win, :]
        out = wy * sl if out is None else out + wy * sl
    return out


def block_iters_ref(
    dpatch, Ip, gxp, gyp, a11, a12, a22, inv_det, bx, by,
    trackable, pts, done, prev_delta, it0,
    *, win: int, n_taps: int, cubic: bool, eps: float, Wd: int, Hd: int,
):
    """Plain version of K1: one BLOCK_ITERS LK update block.

    Masks are bool; returns (pts, done, prev_delta)."""
    dtype = pts.dtype
    half = (win - 1) * 0.5
    eps2 = torch.full((), eps * eps, dtype=dtype, device=pts.device)
    lo, hi = (1.0, n_taps - 2.0) if cubic else (0.0, n_taps - 1.0)
    for j in range(BLOCK_ITERS):
        ox = pts[0] - half + bx
        oy = pts[1] - half + by
        # while sampling clamps at the stencil edge, deltas are artifacts:
        # such a point must not latch done; the next block re-anchors it
        clamped = (ox < lo) | (ox > hi) | (oy < lo) | (oy > hi)
        Jp = _sample_taps(dpatch, oy, ox, win, n_taps, cubic=cubic)
        diff = Jp - Ip
        b1 = torch.sum(diff * gxp, dim=(1, 2))
        b2 = torch.sum(diff * gyp, dim=(1, 2))
        dx_ = -(a22 * b1 - a12 * b2) * inv_det
        dy_ = -(a11 * b2 - a12 * b1) * inv_det
        delta = torch.clamp(torch.stack([dx_, dy_], dim=0), -REACH, REACH)

        inx = torch.floor(pts[0] - half)
        iny = torch.floor(pts[1] - half)
        in_ok = (inx >= -win) & (iny >= -win) & (inx < Wd) & (iny < Hd)
        active = (~done) & trackable & in_ok
        pts = torch.where(active[None, :], pts + delta, pts)
        small = torch.sum(delta * delta, dim=0) <= eps2
        osc = (it0 + j > 0) & (torch.abs(delta + prev_delta) < 0.01).all(dim=0)
        pts = torch.where((active & osc & ~clamped)[None, :], pts - delta * 0.5, pts)
        done = done | ((small | osc) & ~clamped) | ~in_ok
        prev_delta = torch.where(active[None, :], delta, prev_delta)
    return pts, done, prev_delta


def _check_cuda(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"lk_block: {name} must be contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def lk_block(
    dpatch, Ip, gxp, gyp, a11, a12, a22, inv_det, bx, by,
    trackable, pts, done, prev_delta, it0: int,
    *, win: int, n_taps: int, cubic: bool, eps: float, Wd: int, Hd: int,
):
    """One BLOCK_ITERS LK update block; masks are bool in and out.

    A CPU ``dpatch`` takes ``block_iters_ref``; a CUDA one launches K1 or
    raises.
    """
    kw = dict(win=win, n_taps=n_taps, cubic=cubic, eps=eps, Wd=Wd, Hd=Hd)
    dev = dpatch.device
    if dev.type == "cpu":
        return block_iters_ref(dpatch, Ip, gxp, gyp, a11, a12, a22, inv_det, bx, by,
                               trackable, pts, done, prev_delta, it0, **kw)
    if dev.type != "cuda":
        raise ValueError(f"lk_block: unsupported device {dev}")
    lib = cuda_build.library()
    N, P, _ = dpatch.shape
    f32 = torch.float32
    _check_cuda("dpatch", dpatch, (N, P, P), f32, dev)
    for name, t in (("Ip", Ip), ("gxp", gxp), ("gyp", gyp)):
        _check_cuda(name, t, (N, win, win), f32, dev)
    for name, t in (("a11", a11), ("a12", a12), ("a22", a22), ("inv_det", inv_det),
                    ("bx", bx), ("by", by)):
        _check_cuda(name, t, (N,), f32, dev)
    for name, t in (("trackable", trackable), ("done", done)):
        _check_cuda(name, t, (N,), torch.bool, dev)
    _check_cuda("pts", pts, (2, N), f32, dev)
    _check_cuda("prev_delta", prev_delta, (2, N), f32, dev)
    pts_o = torch.empty((2, N), dtype=f32, device=dev)
    done_o = torch.empty((N,), dtype=torch.bool, device=dev)
    pd_o = torch.empty((2, N), dtype=f32, device=dev)
    if N == 0:
        return pts_o, done_o, pd_o
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.vt_lk_block(
        dpatch.data_ptr(), P, Ip.data_ptr(), gxp.data_ptr(), gyp.data_ptr(), win,
        a11.data_ptr(), a12.data_ptr(), a22.data_ptr(), inv_det.data_ptr(),
        bx.data_ptr(), by.data_ptr(), trackable.data_ptr(), pts.data_ptr(),
        done.data_ptr(), prev_delta.data_ptr(), int(it0), N, n_taps, int(cubic),
        float(eps * eps), int(Wd), int(Hd),
        pts_o.data_ptr(), done_o.data_ptr(), pd_o.data_ptr(), stream)
    cuda_build.check(rc, "vt_lk_block")
    lk_block.launches += 1
    key = (win, bool(cubic))
    lk_block.launches_by_shape[key] = lk_block.launches_by_shape.get(key, 0) + 1
    return pts_o, done_o, pd_o


lk_block.launches = 0
lk_block.launches_by_shape = {}  # (win, cubic) -> launches
