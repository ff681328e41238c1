"""Feature-axis sharded tracking (torch twin of
``velocity_tpu/parallel/track_shard.py``).

Every point's window solve is independent given the frame pyramids, so the
static-capacity track axis partitions over a mesh axis while the images
replicate. Each shard tracks its lanes with the unchanged lanes-last engine
(K1 and K2 and all) and rebuilds its own pyramids; there is no
communication inside LK. The results are put back together in lane order.
"""

from __future__ import annotations

import torch

from velocity_tpu_torch.ops.lk import LKResult
from velocity_tpu_torch.ops.lk_lanes import lk_forward_backward_lanes
from velocity_tpu_torch.parallel.mesh import Mesh


def lk_forward_backward_sharded(
    src_img,
    dst_img,
    pts_src,  # (N, 2); N divisible by the mesh axis size
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

    Results are bit-identical to the single call: per-point math is
    independent, and an LK block with no active point is a no-op.
    """
    comm = mesh.axis(axis)
    N = pts_src.shape[0]
    if N % comm.size != 0:
        raise ValueError(f"track capacity {N} not divisible by {comm.size}")
    per = N // comm.size
    points, status = [], []
    for s in comm.indices:
        dev = mesh.device(**{axis: s})
        sl = slice(s * per, (s + 1) * per)
        r = lk_forward_backward_lanes(
            src_img.to(dev), dst_img.to(dev), pts_src[sl].to(dev), fb_threshold=fb_threshold,
            guess=None if guess is None else guess[sl].to(dev),
            warp_dst=None if warp_dst is None else warp_dst.to(dev), **kw)
        points.append(r.points)
        status.append(r.status.to(torch.uint8))  # summed over ranks as a count
    dev = pts_src.device
    return LKResult(points=comm.gather(points, dim=0).to(dev),
                    status=comm.gather(status, dim=0).to(dev) > 0)
