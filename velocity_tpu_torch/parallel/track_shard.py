"""Feature-axis sharded tracking (torch twin of
``velocity_tpu/parallel/track_shard.py``).

Every point's window solve is independent given the frame pyramids, so the
static-capacity track axis partitions over a mesh axis while the images
replicate. Each shard tracks its lanes with the unchanged lanes-last engine
(K1 and K2 and all) and rebuilds its own pyramids; there is no
communication inside LK. The results are put back together in lane order.

Under ``run_batch`` (JAX vmaps the ``shard_map`` over videos, the video axis
unsharded) the images are a stack (V, H, W) and the points V*N lane-major:
shard s then takes the slice s of every video's points, and the results go
back along each video's point axis.
"""

from __future__ import annotations

import torch

from velocity_tpu_torch.ops.lk import LKResult
from velocity_tpu_torch.ops.lk_lanes import lk_forward_backward_lanes
from velocity_tpu_torch.parallel.mesh import Mesh


def lk_forward_backward_sharded(
    src_img,
    dst_img,
    pts_src,  # (N, 2), or (V*N, 2) with (V, H, W) images; N divisible by the axis size
    mesh: Mesh,
    axis: str = "feature",
    *,
    fb_threshold=None,
    guess=None,
    warp_dst=None,
    **kw,
) -> LKResult:
    """Forward-backward lanes LK with the point axis sharded over ``mesh``
    axis ``axis`` (shard s on ``mesh.device(axis=s)``).

    With a stack of V images, shard s tracks points s*per..(s+1)*per-1 of
    every video (per = N / axis size), lane-major, and each video's one
    ``warp_dst`` (V, 2, 3) goes whole to every shard.

    Results are bit-identical to the single call: per-point math is
    independent, and an LK block with no active point is a no-op.
    """
    comm = mesh.axis(axis)
    V = src_img.shape[0] if src_img.dim() == 3 else 1
    N = pts_src.shape[0] // V
    if N % comm.size != 0:
        raise ValueError(f"track capacity {N} not divisible by {comm.size}")
    per = N // comm.size

    def shard(x, s):  # (V*N, ...) -> shard s's (V*per, ...), lane-major
        return x.reshape(V, N, *x.shape[1:])[:, s * per:(s + 1) * per].reshape(
            V * per, *x.shape[1:])

    points, status = [], []
    for s in comm.indices:
        dev = mesh.device(**{axis: s})
        r = lk_forward_backward_lanes(
            src_img.to(dev), dst_img.to(dev), shard(pts_src, s).to(dev),
            fb_threshold=fb_threshold, guess=None if guess is None else shard(guess, s).to(dev),
            warp_dst=None if warp_dst is None else warp_dst.to(dev), **kw)
        points.append(r.points.reshape(V, per, 2))
        status.append(r.status.to(torch.uint8).reshape(V, per))  # summed over ranks
    dev = pts_src.device
    return LKResult(points=comm.gather(points, dim=1).to(dev).reshape(V * N, 2),
                    status=comm.gather(status, dim=1).to(dev).reshape(V * N) > 0)
