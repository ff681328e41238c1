"""Scale-transfer re-anchoring of the structure once baseline accumulates.

Torch twin of ``velocity_tpu/pipeline/anchor.py``. Two strategies, selected
by ``PipelineConfig.anchor``:

- "msv": the reference's active path, multi-view ray-intercept triangulation
  plus Gauss-Newton over the newest camera (fcnMSV1_t), preceded by the
  frame-0 planar-pose disambiguation;
- "ba": the reference's dormant path, bundle adjustment over frames 0..i
  that refines the structure and the camera track together (Schur solver).
  Identity damping keeps the free monocular scale gauge pinned to the
  plate-anchored init.

Both run on the host CPU in float64, once per video, as in the JAX design
(triangulating distant background features amplifies noise).
"""

from __future__ import annotations

import numpy as np
import torch

from velocity_tpu_torch.config import PipelineConfig
from velocity_tpu_torch.solvers.ba import BAProblem
from velocity_tpu_torch.solvers.schur import ba_schur
from velocity_tpu_torch.solvers.triangulate import msv_refine_translation
from velocity_tpu_torch.utils import profiling

F64 = torch.float64


def resolve_plate_pose(intr64, q, track_px, cfg: PipelineConfig):
    """Pick the branch of the frame-0 planar plate pose that the early
    tracks support.

    For each candidate pose, backproject the frame-0 plate-box features onto
    its plate plane, re-solve the per-frame translations (numpy twin of the
    device solve, with its robust second pass) and keep the branch with the
    lower mean reprojection rms. Returns (pose0, p3_plate (N,3),
    t_track (k+1,3), res_track (k+1,)), t_track[0] = 0. Inside a driver's
    run the candidates' solve is the span ``reanchor.plate_pose.polish``,
    their scoring ``reanchor.plate_pose.score``, and the counter
    ``plate_pose.candidates`` adds the number scored.
    """
    from velocity_tpu_torch.geometry.plate import license_plate_points
    from velocity_tpu_torch.geometry.projection import image_to_world_plane
    from velocity_tpu_torch.pipeline.roi import bounding_rect, inside_bbox
    from velocity_tpu_torch.solvers.pose import plate_pose_candidates, solve_translation_np

    k1, N, _ = track_px.shape
    plate = torch.as_tensor(license_plate_points(cfg.plate_country), dtype=F64)
    q64 = torch.as_tensor(q, dtype=F64)
    with profiling.span("reanchor.plate_pose.polish"):
        cands = plate_pose_candidates(intr64, q64, plate, cfg.solver)
    profiling.count("plate_pose.candidates", len(cands))
    p0 = np.nan_to_num(track_px[0].astype(np.float64))
    valid0 = np.isfinite(track_px[0]).all(axis=1)
    boxa = bounding_rect(np.asarray(q), (10**9, 10**9), border=(0, 0))
    vp0 = valid0 & inside_bbox(p0, boxa)
    scfg = cfg.solver

    def _solve_frame(pix_f, p3c, m, prev):
        t, rms = solve_translation_np(
            intr64, pix_f, p3c, prev, m, max_iters=scfg.max_iters_pose,
            damping=scfg.damping, tol=scfg.tol, ramp_rate=scfg.ramp_rate)
        if (scfg.pose_reject_sigma > 0 and scfg.pose_reject_above_px > 0
                and rms > scfg.pose_reject_above_px):
            fx, fy = float(intr64.fx), float(intr64.fy)
            cx, cy = float(intr64.cx), float(intr64.cy)
            pc = p3c + t
            u = fx * pc[:, 0] / pc[:, 2] + cx
            v = fy * pc[:, 1] / pc[:, 2] + cy
            err = np.where(m, np.hypot(pix_f[:, 0] - u, pix_f[:, 1] - v), 0.0)
            rms1 = np.sqrt((err ** 2).sum() / max(m.sum(), 1))
            m2 = m & (err <= scfg.pose_reject_sigma * rms1)
            if m2.sum() >= 8:
                t, rms = solve_translation_np(
                    intr64, pix_f, p3c, t, m2,
                    max_iters=scfg.max_iters_pose, damping=scfg.damping,
                    tol=scfg.tol, ramp_rate=scfg.ramp_rate)
        return t, rms

    with profiling.span("reanchor.plate_pose.score"):
        best = None
        for cand in cands:
            pw2 = image_to_world_plane(intr64, cand.R, cand.t,
                                       torch.as_tensor(p0, dtype=F64)).numpy()
            p3c = (np.concatenate([pw2, np.zeros((N, 1))], 1)
                   @ cand.R.numpy() + cand.t.numpy())
            t_track = np.zeros((k1, 3))
            res_track = np.zeros(k1)
            res_track[0] = float(cand.residual_rms)
            prev = np.zeros(3)
            for f in range(1, k1):
                m = vp0 & np.isfinite(track_px[f]).all(axis=1)
                pix_f = np.nan_to_num(track_px[f].astype(np.float64))
                t_f, rms_f = _solve_frame(pix_f, p3c, m, prev)
                t_track[f] = t_f
                res_track[f] = rms_f
                prev = t_f
            score = float(res_track[1:].mean()) if k1 > 1 else res_track[0]
            if best is None or score < best[0]:
                best = (score, cand, p3c, t_track, res_track)
    _score, pose0, p3c, t_track, res_track = best
    return pose0, p3c, t_track, res_track


@profiling.spanned("reanchor")
def reanchor(
    cfg: PipelineConfig,
    cam,
    scale: float,
    track_px: np.ndarray,  # (i+1, N, 2) pixel history, NaN where invalid
    vg: np.ndarray,  # (N,) current global validity
    B: np.ndarray,  # (i+1, 14) car rows (B[:,0:3] positions)
    t_cur: np.ndarray,  # (3,) current frame translation
    p3: np.ndarray,  # (N, 3) current structure
    q: np.ndarray | None = None,  # (4, 2) plate corners (enables the
    # frame-0 planar-pose disambiguation; None = trust the incoming B/p3)
):
    """Return (p3_new, t_new or None, res_new or None) after the
    scale-transfer refinement, computed on the CPU in float64. ``t_new`` and
    ``res_new`` (rows 0..i) replace the trajectory and residual columns when
    the refinement re-solved them. Inside a driver's run it is the span
    ``reanchor`` and counts its solver's iterations as
    ``reanchor.iterations``; the MSV's phases are the spans
    ``reanchor.plate_pose`` and ``reanchor.msv``, its LM's refused trial
    steps the counter ``msv.rejected``, and ``msv.capped`` is 1 where the LM
    stopped at ``max_iters_msv``."""
    intr64 = cam.intrinsics(scale=scale).to(dtype=F64)
    if cfg.anchor == "ba":
        nf = track_px.shape[0]
        # observations: frames x tracks; a track alive at frame i was alive
        # in all prior frames
        pix = np.nan_to_num(track_px.astype(np.float64), nan=0.0)
        mask = np.repeat(vg[None, :], nf, axis=0) & np.isfinite(track_px[..., 0])
        cams0 = np.zeros((nf, 6))
        cams0[:, 0:3] = B[:nf, 0:3] - B[0, 0:3]  # t_j relative
        prob = BAProblem(
            intr=intr64,
            pixels=torch.as_tensor(pix),
            mask=torch.as_tensor(mask),
            points0=torch.as_tensor(np.where(vg[:, None], p3, np.array([0.0, 0.0, 5.0]))),
            cams0=torch.as_tensor(cams0),
        )
        # translation-only cameras: the pipeline's motion model holds R = I;
        # free rotations are unidentifiable on these tiny baselines and
        # corrupt the track
        res = ba_schur(prob, cfg.ba, fix_rotations=True)
        profiling.count("reanchor.iterations", int(res.iterations))
        p3_new = np.array(p3)
        p3_new[vg] = res.points.numpy()[vg]
        # refined camera track -> absolute rows; the caller updates B
        t_abs = B[0, 0:3] + res.cams.numpy()[:, 0:3]
        return p3_new, t_abs, None

    # default: MSV, preceded by the frame-0 planar-pose disambiguation when
    # the plate corners q are given
    t_cur64 = np.asarray(t_cur, np.float64)
    origins = np.array(B[: track_px.shape[0], 0:3], np.float64)
    p3_base = np.array(p3)
    t_abs = None
    res_new = None
    if q is not None:
        with profiling.span("reanchor.plate_pose"):
            pose0, p3c, t_rel, res_track = resolve_plate_pose(intr64, q, track_px, cfg)
        t0_new = pose0.t.numpy().astype(np.float64)
        t_abs = t0_new[None, :] + t_rel
        origins = t_abs
        p3_base = np.where(np.isfinite(track_px[0]).all(axis=1)[:, None], p3c, p3)
        t_cur64 = t_rel[-1]
        res_new = res_track
    with profiling.span("reanchor.msv"):
        msv = msv_refine_translation(
            intr64,
            torch.as_tensor(track_px, dtype=F64),
            torch.as_tensor(vg),
            torch.as_tensor(origins, dtype=F64),
            config=cfg.solver,
        )
    profiling.count("reanchor.iterations", int(msv.iterations))
    profiling.count("msv.rejected", msv.rejected)
    profiling.count("msv.capped", int(msv.iterations >= cfg.solver.max_iters_msv))
    cloud = msv.points.numpy() - t_cur64
    p3_new = np.array(p3_base)
    p3_new[vg] = cloud[vg]
    return p3_new, t_abs, res_new


def write_back(tables, i: int, t_abs, res_new, t, per_frame: bool = False):
    """Put ``reanchor``'s trajectory ``t_abs`` and residuals ``res_new``
    (either None where it kept them) into rows 0..i of the run's tables
    (``speedest.RunTables``). ``per_frame``: the driver records ``S`` frame
    by frame, and the rows it recorded are rewritten in the new gauge, save
    that frame i keeps the residual, step and speed it measured before the
    re-anchor, as in the JAX driver. Returns the translation frame i + 1
    starts from: ``t``, or t_abs[-1] - t_abs[0] in its dtype on its device."""
    S = tables.S
    measured = S[i, [3, 6, 8]]
    if res_new is not None:
        tables.res[: i + 1] = res_new
    if t_abs is not None:
        tables.B[: i + 1, 0:3] = t_abs
        tables.B[: i + 1, 3:6] = t_abs - t_abs[0]
        if per_frame:
            S[: i + 1, 6:9] = tables.stats(0.0, i + 1)[:, 6:9]
        t = torch.as_tensor(t_abs[-1] - t_abs[0], dtype=t.dtype, device=t.device)
    if per_frame:
        S[i, [3, 6, 8]] = measured
    return t
