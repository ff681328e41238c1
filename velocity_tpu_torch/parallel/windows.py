"""Frame-window data parallelism + pose-graph stitching for long sequences
(torch twin of ``velocity_tpu/parallel/windows.py``).

A video is cut into overlapping keyframe windows; each window's bundle
adjustment is independent given its boundary anchors, so windows run as one
batch (a leading dimension of every Schur block, sharded over a mesh axis)
while each window's tracks shard over a second axis (the ``ba_dist`` Schur
reduction). Windows are then stitched into a global trajectory by aligning
the overlapping frames: a chain pose graph, which is the exact graph shape
of forward vehicle motion. ``split_windows``, ``align_overlap`` and
``stitch_windows`` are host numpy, copied.
"""

from __future__ import annotations

import numpy as np

from velocity_tpu_torch.config import BAConfig
from velocity_tpu_torch.parallel.ba_dist import sharded_schur
from velocity_tpu_torch.parallel.mesh import Mesh


def split_windows(n_frames: int, window: int, overlap: int = 1):
    """[(start, end), ...] covering n_frames with ``overlap`` shared frames."""
    if window <= overlap:
        raise ValueError("window must exceed overlap")
    out = []
    s = 0
    while True:
        e = min(s + window, n_frames)
        out.append((s, e))
        if e >= n_frames:
            return out
        s = e - overlap


def windowed_ba(
    pixels,  # (nw, nc, nt, 2)
    mask,  # (nw, nc, nt)
    points0,  # (nw, nt, 3)
    cams0,  # (nw, nc, 6)
    intr,
    mesh: Mesh,
    window_axis: str = "window",
    point_axis: str = "point",
    config: BAConfig = BAConfig(),
    fix_rotations: bool = False,
    pin_tracks: int = 0,
):
    """Batched per-window Schur BA: windows sharded over ``window_axis``,
    each window's tracks sharded over ``point_axis``.

    Each window shard is one batched ``sharded_schur``: a window that has
    converged stops moving and counting while the others run on (JAX's
    ``vmap`` of a ``while_loop``).

    ``pin_tracks``: hold the first k tracks' structure fixed (their point
    Jacobians zero), by global lane index whatever the shard layout.
    Monocular BA has a scale gauge (points and cameras can shrink or grow
    jointly without changing any reprojection), so refinement must pin the
    metric anchor: the plate-corner tracks (lanes 0..3 by construction)
    whose geometry carries the plate's known size.

    Returns (points (nw, nt, 3), cams (nw, nc, 6), iterations (nw,) int32),
    on the device of ``pixels``.
    """
    wcomm, pcomm = mesh.axis(window_axis), mesh.axis(point_axis)
    nw = pixels.shape[0]
    if nw % wcomm.size != 0:
        raise ValueError(f"window count {nw} not divisible by mesh axis {wcomm.size}")
    per = nw // wcomm.size
    out = []
    for w in wcomm.indices:
        sl = slice(w * per, (w + 1) * per)
        out.append(sharded_schur(
            pixels[sl], mask[sl], points0[sl], cams0[sl], intr, pcomm,
            lambda s, w=w: mesh.device(**{window_axis: w, point_axis: s}), config,
            fix_rotations, pin_tracks))
    dev = pixels.device
    return tuple(wcomm.gather(parts, dim=0).to(dev) for parts in zip(*out))


def _umeyama(src, dst, with_scale: bool):
    """Least-squares similarity (R, s, t) with dst ~= s * R @ src + t
    (Umeyama 1991). src/dst: (k, 3)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (sc * sc).sum() / src.shape[0]
    s = float((D * np.diag(S)).sum() / var_s) if (with_scale and var_s > 0) else 1.0
    t = mu_d - s * R @ mu_s
    return R, s, t


def align_overlap(local_shared, global_shared, gauge: str = "auto"):
    """(R, s, t) mapping a window's local gauge onto the stitched global one,
    estimated from the shared (overlap) frames: ``global ~= s * R @ local + t``.

    ``gauge="similarity"``/"auto" fits the full Umeyama similarity when >= 3
    non-collinear shared frames exist; otherwise (or with
    ``gauge="translation"``) the fit degenerates to the mean offset. This is
    the variable-length form of ``stitch_windows`` used by the long-video
    driver, whose tracking segments are unequal.
    """
    local_shared = np.asarray(local_shared, np.float64)
    global_shared = np.asarray(global_shared, np.float64)
    k = local_shared.shape[0]
    use_sim = gauge in ("similarity", "auto") and k >= 3
    if use_sim:
        span = np.linalg.matrix_rank(
            local_shared - local_shared.mean(0), tol=1e-9)
        if span >= 2:
            return _umeyama(local_shared, global_shared, with_scale=True)
    t = (global_shared - local_shared).mean(axis=0)
    return np.eye(3), 1.0, t


def stitch_windows(cam_positions, overlap: int = 1, gauge: str = "auto"):
    """Chain-stitch per-window camera trajectories into one global trajectory.

    Each window's BA fixes its own gauge (window-local frame, first camera at
    the origin); consecutive windows share ``overlap`` frames, from which the
    inter-window transform is estimated:

    - ``gauge="translation"``: mean offset of the shared frames only (valid
      when rotations are pinned per window, e.g. the fix_rotations motion
      model, and the metric scale is plate-anchored in every window).
    - ``gauge="similarity"``: full Umeyama rotation+scale+translation fit on
      the shared frames — needed when per-window BA leaves rotation/scale
      gauge freedom. Requires overlap >= 3 non-collinear shared frames;
      degenerate overlaps fall back per-pair to translation.
    - ``gauge="auto"``: similarity when overlap >= 3, else translation.

    Args:
      cam_positions: (nw, F, 3) per-window positions, window-local frames.
      overlap: number of shared frames between consecutive windows.

    Returns:
      (n_total, 3) global positions, n_total = nw*F - (nw-1)*overlap.
    """
    cam_positions = np.asarray(cam_positions)
    nw, F, _ = cam_positions.shape
    use_sim = (gauge == "similarity") or (gauge == "auto" and overlap >= 3)
    out = [cam_positions[0].copy()]
    for w in range(1, nw):
        prev_g = out[-1][-overlap:] if overlap <= F else out[-1]
        cur = cam_positions[w]
        if use_sim and overlap >= 3:
            # guard collinear/degenerate overlap (vehicle path is near-linear):
            # similarity is well-posed only when the shared frames span a plane
            span = np.linalg.matrix_rank(
                (cur[:overlap] - cur[:overlap].mean(0)), tol=1e-9
            )
            if span >= 2:
                R, s, t = _umeyama(cur[:overlap], prev_g, with_scale=True)
            else:
                R, s, t = np.eye(3), 1.0, (prev_g - cur[:overlap]).mean(axis=0)
        else:
            R, s, t = np.eye(3), 1.0, (prev_g - cur[:overlap]).mean(axis=0)
        mapped = (s * (R @ cur.T)).T + t
        out.append(mapped[overlap:])
    return np.concatenate(out, axis=0)
