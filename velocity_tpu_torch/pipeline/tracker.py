"""Three-stage coarse-to-fine KLT tracker (torch twin of
``velocity_tpu/pipeline/tracker.py``).

1. coarse LK on 1/4-scale frames (win 15, 4 levels) + RANSAC affine inliers;
2. translation-prior LK at full resolution, forward-backward gate 1 px;
3. RANSAC affine from the stage-2 survivors, then fine LK (win 51, one
   level) through that affine with forward-backward gate 0.3 px;
then the masked translation LM. ``fused_frame_step_pyr`` is one frame of
that, on pyramids built once per frame and carried to the next;
``fused_frame_step``, ``_track_stages``, ``_track_fine`` and
``ThreeStageTracker.track`` are the image-input forms, which rebuild the
previous frame's pyramids at every call.

``TrackerConfig.lk_backend`` picks the LK engine: "lanes" (the default,
``ops/lk_lanes.py``, on the carried pyramids), "fast" (``ops/lk_fast.py``)
or any other value for the gather engine (``ops/lk.py``); the last two
rebuild their pyramids inside each call, as in JAX. With "lanes" and
``shard_features > 1`` the forward-backward stages split their lanes over
that many shards (``_sharded_fb``).

Lanes (JAX's ``run_batch`` vmaps the step over videos): with every backend
and any ``shard_features``, ``fused_frame_step_pyr`` and the stage functions
below it take a leading lane axis on every input (frames and pyramid levels
(V, H, W) of equal size, points (V, N, ...), stacked ``Intrinsics``, one
RANSAC generator per lane in a list) and return one. The LK engine then
tracks all lanes' points in one pass on image stacks (the lanes engine: one
K2 and one K1 launch per block; the fast one: one K3 launch per patch set;
with feature shards, each shard a slice of every lane's points), RANSAC and
the pose LM run batched with each lane's reductions its own, and each lane
gets the bits of its own step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from velocity_tpu_torch.config import TrackerConfig
from velocity_tpu_torch.ops.lk import lk_forward_backward, lk_pyramidal
from velocity_tpu_torch.ops.lk_fast import lk_forward_backward_fast, lk_pyramidal_fast
from velocity_tpu_torch.ops.lk_lanes import lk_forward_backward_lanes, lk_pyramidal_lanes
from velocity_tpu_torch.ops.pyramid import build_pyramid, resize_nearest
from velocity_tpu_torch.ops.ransac import _map_points, estimate_affine_ransac


def _lk_impls(cfg: TrackerConfig):
    """(pyramidal LK, forward-backward LK) of the configured backend."""
    if cfg.lk_backend == "lanes":
        if cfg.shard_features > 1:
            return lk_pyramidal_lanes, _sharded_fb(cfg)
        return lk_pyramidal_lanes, lk_forward_backward_lanes
    if cfg.lk_backend == "fast":
        return lk_pyramidal_fast, lk_forward_backward_fast
    return lk_pyramidal, lk_forward_backward


def _sharded_fb(cfg: TrackerConfig):
    """Forward-backward LK with the lane axis sharded over a ``feature``
    mesh of ``cfg.shard_features`` shards on the device of the points
    (``parallel/track_shard.py``). The prebuilt-pyramid kwargs are dropped:
    each shard rebuilds its pyramids."""
    from velocity_tpu_torch.parallel.mesh import make_mesh
    from velocity_tpu_torch.parallel.track_shard import lk_forward_backward_sharded

    def fb(src_img, dst_img, pts_src, *, src_pyr=None, dst_pyr=None, **kw):
        n = cfg.shard_features
        mesh = make_mesh({"feature": n}, devices=[pts_src.device] * n)
        return lk_forward_backward_sharded(src_img, dst_img, pts_src, mesh, "feature", **kw)

    return fb


def _pyr_kw(cfg: TrackerConfig, src_pyr, dst_pyr):
    """Prebuilt-pyramid kwargs (lanes backend only; the others rebuild)."""
    if cfg.lk_backend == "lanes":
        return dict(src_pyr=src_pyr, dst_pyr=dst_pyr)
    return {}


def frame_pyramids(im, cfg: TrackerConfig, dtype=torch.float32):
    """(full, small): float pyramids of the frame (or of each frame of a
    stack (V, H, W)) and of its 1/4-scale INTER_NEAREST image, built once
    per frame."""
    f = im.to(dtype)
    full = tuple(build_pyramid(f, cfg.lk_coarse.max_level))
    small_img = resize_nearest(f, cfg.coarse_scale)
    small = tuple(build_pyramid(small_img, cfg.lk_coarse.max_level))
    return full, small


class TrackOutput(NamedTuple):
    points: torch.Tensor  # (N, 2) tracked positions (valid lanes only meaningful)
    valid: torch.Tensor  # (N,) bool: input valid & stage-3 survival
    small_cur: torch.Tensor  # 1/4-scale current frame (for reuse next frame)
    affine: torch.Tensor  # (2, 3) stage-3 affine prior actually used
    n_stage2: torch.Tensor  # stage-2 survivor count (fallback trigger)


def _car_mask(pts, valid, cfg: TrackerConfig):
    """Lanes within ``car_margin`` plate diagonals of the tracked plate
    corners (lanes 0..3); ``valid`` when fewer than 8 lanes qualify."""
    qv = pts[..., 0:4, :]
    lo = torch.amin(qv, dim=-2)
    hi = torch.amax(qv, dim=-2)
    m = cfg.car_margin * torch.sqrt(torch.sum((hi - lo) ** 2, dim=-1))

    def edge(c):  # a bound per lane against the lane's points
        return c[..., None]

    inbox = (
        (pts[..., 0] >= edge(lo[..., 0] - m)) & (pts[..., 0] <= edge(hi[..., 0] + m))
        & (pts[..., 1] >= edge(lo[..., 1] - m)) & (pts[..., 1] <= edge(hi[..., 1] + m))
    )
    mc = valid & inbox
    return torch.where(edge(torch.sum(mc, dim=-1)) >= 8, mc, valid)


# RANSAC calls of one frame step, in the order they draw their noise: stage
# 1's inliers, then the stage-3 affine from the stage-2 survivors
RANSAC_CALLS = 2


def _ransac(src, dst, mask, cfg: TrackerConfig, generator):
    return estimate_affine_ransac(src, dst, mask=mask, generator=generator,
                                  trials=cfg.ransac_trials, threshold=cfg.ransac_threshold)


def _track_stages_p(pyr_prev, pyr_cur, spyr_prev, spyr_cur, pts, valid,
                    generator, cfg: TrackerConfig):
    """Stages 1-2 + the stage-3 affine, on prebuilt per-frame pyramids (of
    one frame, or with lanes; the LK engine sees the lanes' points on one
    axis)."""
    dtype = pts.dtype
    scale = cfg.coarse_scale
    lk_pyr, lk_fb = _lk_impls(cfg)

    # ---- stage 1: coarse global LK on small images + RANSAC inliers ----
    lk1 = cfg.lk_coarse
    r1 = lk_pyr(
        spyr_prev[0].to(dtype), spyr_cur[0].to(dtype), (pts * scale).reshape(-1, 2),
        win=lk1.window, max_level=lk1.max_level, iters=lk1.max_iters, eps=lk1.eps,
        **_pyr_kw(cfg, spyr_prev, spyr_cur),
    )
    p1 = r1.points.reshape(pts.shape) / scale
    v1 = valid & r1.status.reshape(valid.shape)
    m1r = _car_mask(pts, v1, cfg) if cfg.car_affine else v1
    ransac1 = _ransac(pts, p1, m1r, cfg, generator)
    v1 = v1 & ransac1.inliers

    # ---- stage 2: translation-prior LK at full resolution ----
    # an integer-translation destination warp is exactly plain LK seeded at
    # pts + shift (reference: int() truncation of the mean shift)
    m1 = v1.to(dtype)[..., None]
    n1 = torch.clamp(torch.sum(v1, dim=-1), min=1)
    mean_shift = torch.sum((p1 - pts) * m1, dim=-2) / n1[..., None]
    shift_int = torch.trunc(mean_shift)
    # stage 2 keeps lk_coarse's pyramid depth (the reference structure,
    # KLT.py:106,124): the translation guess does not make its upper levels
    # redundant
    lvl2 = lk1.max_level
    r2 = lk_fb(
        pyr_prev[0].to(dtype), pyr_cur[0].to(dtype), pts.reshape(-1, 2),
        guess=(pts + shift_int[..., None, :]).reshape(-1, 2),
        fb_threshold=cfg.fb_threshold_coarse,
        win=lk1.window, max_level=lvl2, iters=lk1.max_iters, eps=lk1.eps,
        **_pyr_kw(cfg, pyr_prev[: lvl2 + 1], pyr_cur[: lvl2 + 1]),
    )
    p2 = r2.points.reshape(pts.shape)
    v2 = valid & r2.status.reshape(valid.shape)
    n2 = torch.sum(v2, dim=-1)

    # ---- affine for stage 3 from stage-2 survivors ----
    m2r = _car_mask(pts, v2, cfg) if cfg.car_affine else v2
    ransac2 = _ransac(pts, p2, m2r, cfg, generator)
    # degenerate guard: if stage 2 collapsed, fall back to the stage-1 model
    use2 = n2 > cfg.min_affine_inliers
    T23 = torch.where(use2[..., None, None], ransac2.M, ransac1.M)
    return T23, n2


def _track_fine_p(pyr_prev, pyr_cur, pts, valid, T23, cfg: TrackerConfig):
    """Stage 3 (fine, affine-warped, fb-gated) on prebuilt pyramids (of one
    frame, or with lanes and one T23 per lane)."""
    dtype = pts.dtype
    lk3 = cfg.lk_fine
    _, lk_fb = _lk_impls(cfg)
    r3 = lk_fb(
        pyr_prev[0].to(dtype), pyr_cur[0].to(dtype), pts.reshape(-1, 2),
        fb_threshold=cfg.fb_threshold_fine, warp_dst=T23,
        win=lk3.window, max_level=lk3.max_level, iters=lk3.max_iters, eps=lk3.eps,
        **_pyr_kw(cfg, pyr_prev[: lk3.max_level + 1], pyr_cur[: lk3.max_level + 1]),
    )
    # map solved (previous-frame) coords through the affine into the current frame
    p3 = _map_points(r3.points.reshape(pts.shape), T23)
    v3 = valid & r3.status.reshape(valid.shape)
    return p3, v3


def _track_stages(im_prev, im_cur, small_prev, pts, valid, generator, cfg: TrackerConfig):
    """Image-input form of ``_track_stages_p`` (rebuilds the pyramids at
    every call): returns (1/4-scale current frame, T23, n_stage2)."""
    dtype = pts.dtype
    L = cfg.lk_coarse.max_level
    pyr_prev = tuple(build_pyramid(im_prev.to(dtype), L))
    pyr_cur, spyr_cur = frame_pyramids(im_cur, cfg, dtype)
    spyr_prev = tuple(build_pyramid(small_prev.to(dtype), L))
    T23, n2 = _track_stages_p(pyr_prev, pyr_cur, spyr_prev, spyr_cur, pts, valid,
                              generator, cfg)
    return spyr_cur[0], T23, n2


def _track_fine(im_prev, im_cur, pts, valid, T23, cfg: TrackerConfig):
    """Image-input form of ``_track_fine_p``."""
    dtype = pts.dtype
    L = cfg.lk_fine.max_level
    pyr_prev = tuple(build_pyramid(im_prev.to(dtype), L))
    pyr_cur = tuple(build_pyramid(im_cur.to(dtype), L))
    return _track_fine_p(pyr_prev, pyr_cur, pts, valid, T23, cfg)


def _step_core(pyr_prev, spyr_prev, pyr_cur, spyr_cur, pts, vg, vp, p3, intr,
               generator, t0, cfg, solver_cfg, solver_dtype):
    """Track + mask composition + pose solve on prebuilt pyramids."""
    from velocity_tpu_torch.config import SolverConfig
    from velocity_tpu_torch.solvers.pose import estimate_world_camera_pose, unit_z

    if solver_cfg is None:
        solver_cfg = SolverConfig()
    dev = pts.device

    T23, n2 = _track_stages_p(pyr_prev, pyr_cur, spyr_prev, spyr_cur, pts, vg,
                              generator, cfg)
    p_new, vg_new = _track_fine_p(pyr_prev, pyr_cur, pts, vg, T23, cfg)
    vp_new = vp & vg_new

    if t0 is None:
        t0 = unit_z(solver_dtype, dev).expand(pts.shape[:-2] + (3,))
    pose = estimate_world_camera_pose(
        intr,
        p_new.to(solver_dtype),
        p3,
        t0=t0.to(solver_dtype),
        R0=torch.eye(3, dtype=solver_dtype, device=dev),
        find_R=False,
        mask=vp_new,
        config=solver_cfg,
    )
    return p_new, vg_new, vp_new, pose.t, pose.residual_rms, pose.p_proj, n2, T23


def fused_frame_step_pyr(
    pyr_prev,  # tuple: previous frame's full-res pyramid (the carry)
    spyr_prev,  # tuple: previous frame's 1/4-scale pyramid
    im_cur,  # (H, W) current frame (uint8 ok)
    pts,
    vg,
    vp,
    p3,
    intr,
    generator,
    cfg: TrackerConfig,
    solver_cfg=None,
    solver_dtype=torch.float32,
    t0=None,
):
    """One frame step with pyramid carry: builds the current frame's
    pyramids once and returns them for the next step, then
    (pts', vg', vp', t, residual_rms, p_proj, n_stage2, T23).
    ``t0`` warm-starts the pose solve from the previous translation.

    The step copies nothing to the device. Its loops (JAX's
    ``lax.while_loop`` of the LK blocks and of the pose LM) stop early where
    it runs eagerly, with one host read per trip; while it is captured
    (``utils/loops.py``) they run their fixed trip count and it reads
    nothing back, with the same bits, so on a card it is captured as a
    CUDA graph (``pipeline/step_graph.py``).

    With lanes (any backend and ``shard_features``): ``im_cur`` (V, H, W),
    the pyramids' levels (V, h, w), pts (V, N, 2), vg and vp (V, N), p3
    (V, N, 3), ``intr`` from ``Intrinsics.stack``, ``generator`` a list of V
    generators, t0 (V, 3); every output gains the lane axis."""
    pyr_cur, spyr_cur = frame_pyramids(im_cur, cfg)
    outs = _step_core(pyr_prev, spyr_prev, pyr_cur, spyr_cur, pts, vg, vp, p3, intr,
                      generator, t0, cfg, solver_cfg, solver_dtype)
    return (pyr_cur, spyr_cur) + outs


def pack_summary(t, residual_rms, vg, n2):
    """One frame's packed summary, float32 (6,) on the step's device:
    [t(3), residual_rms, live lanes, stage-2 survivors] (JAX's ``packed``,
    ``velocity_tpu/pipeline/tracker.py:275-282``), (V, 6) with lanes. A
    transfer-lean run reads this one vector per frame in place of the
    per-point history."""
    return torch.cat([t.float(), residual_rms.float()[..., None],
                      vg.sum(dim=-1).float()[..., None], n2.float()[..., None]], dim=-1)


def fused_frame_step(
    im_prev,
    im_cur,
    small_prev,
    pts,
    vg,
    vp,
    p3,
    intr,
    generator,
    cfg: TrackerConfig,
    solver_cfg=None,
    solver_dtype=torch.float32,
):
    """Image-input frame step (rebuilds the previous frame's pyramids):
    returns (pts', vg', vp', small_cur, t, residual_rms, p_proj, n_stage2,
    T23). Steady-state drivers use ``fused_frame_step_pyr``."""
    L = cfg.lk_coarse.max_level
    pyr_prev = tuple(build_pyramid(im_prev.to(torch.float32), L))
    spyr_prev = tuple(build_pyramid(small_prev.to(torch.float32), L))
    pyr_cur, spyr_cur = frame_pyramids(im_cur, cfg)
    (p_new, vg_new, vp_new, t, res, pproj, n2, T23) = _step_core(
        pyr_prev, spyr_prev, pyr_cur, spyr_cur, pts, vg, vp, p3, intr,
        generator, None, cfg, solver_cfg, solver_dtype)
    return p_new, vg_new, vp_new, spyr_cur[0], t, res, pproj, n2, T23


class ThreeStageTracker:
    """A ``TrackerConfig`` bound to an optional fallback matcher.

    ``fallback_matcher(im_prev, im_cur, pts, valid) -> (2, 3) affine`` (numpy
    in, numpy out) stands in for the reference's SURF full-frame rescue when
    stage 2 leaves too few survivors. ``track`` uses the stage-1 RANSAC
    model where none was given; the per-frame driver
    (``pipeline/speedest.py``) then runs the cv2 feature match.
    """

    def __init__(self, cfg: TrackerConfig, fallback_matcher: Callable | None = None):
        self.cfg = cfg
        self.fallback_matcher = fallback_matcher

    def track(self, im_prev, im_cur, small_prev, pts, valid, generator=None) -> TrackOutput:
        cfg = self.cfg
        small_cur, T23, n2 = _track_stages(im_prev, im_cur, small_prev, pts, valid,
                                           generator, cfg)
        if self.fallback_matcher is not None and int(n2) <= cfg.min_affine_inliers:
            M = self.fallback_matcher(im_prev.cpu().numpy(), im_cur.cpu().numpy(),
                                      pts.cpu().numpy(), valid.cpu().numpy())
            T23 = torch.as_tensor(M, dtype=pts.dtype, device=pts.device)
        p3, v3 = _track_fine(im_prev, im_cur, pts, valid, T23, cfg)
        return TrackOutput(points=p3, valid=v3, small_cur=small_cur, affine=T23, n_stage2=n2)

    def initial_small(self, im_prev):
        return resize_nearest(im_prev, self.cfg.coarse_scale)
