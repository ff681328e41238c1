"""The per-frame speed-estimation driver, its run results and the frame-0
initialisation.

Torch twin of ``velocity_tpu/pipeline/speedest.py``. Frame protocol:

  frame 0: Harris corners in the plate ROI + subpixel refinement (on the
           device), 6-DoF plate solve and plane backprojection of all
           features (on the host CPU in float64), R := I;
  frame i: 3-stage KLT -> mask composition -> 3-parameter translation solve
           on the plate-proximal subset -> speed integration; when stage 2
           leaves too few survivors, a full-frame feature match supplies the
           stage-3 affine and the fine stage and the solve run again;
  frame msv_frame: the re-anchor (``pipeline/anchor.py``) replaces the
           structure and widens the solve to all features.

``SpeedEstimator.run`` decodes, uploads and steps one frame at a time. On a
card each step is one replay of the frame step's CUDA graph
(``pipeline/step_graph.py``, the capture the scan runner's non-lean
segments share), as JAX's driver calls its jitted step; the host then reads
the stage-2 count for the rescue test and runs the rare rescue eagerly, as
JAX runs it unjitted. On the CPU the step runs eagerly.
``ScanSpeedRunner`` (``pipeline/scan.py``) is the batch form of the same
protocol and hands a clip whose tracking collapsed to this driver. With
``lean=True`` both read one packed summary per frame after the MSV frame
(``tracker.pack_summary``) in place of the per-point history.

Every driver of the package starts from ``_init_frame0`` (frame 0's state)
and records into ``RunTables`` (the run's tables); ``SpeedEstimator`` holds
the one per-frame loop (``_run_frames``), which the stills driver
(``pipeline/stills.py``) runs with its own reader and ``_after_frame``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from pathlib import Path

import numpy as np
import torch

from velocity_tpu_torch.camera.annotations import Annotation, find_annotation, load_annotation
from velocity_tpu_torch.camera.database import CameraInfo
from velocity_tpu_torch.config import PipelineConfig, SolverConfig
from velocity_tpu_torch.geometry.plate import license_plate_points
from velocity_tpu_torch.geometry.projection import Intrinsics, image_to_world_plane
from velocity_tpu_torch.ops.harris import _corner_subpix, good_features
from velocity_tpu_torch.pipeline import report
from velocity_tpu_torch.pipeline.roi import bounding_rect, inside_bbox
from velocity_tpu_torch.pipeline.step_graph import _graph_step
from velocity_tpu_torch.pipeline.tracker import (
    ThreeStageTracker, _track_fine_p, frame_pyramids, fused_frame_step_pyr, pack_summary)
from velocity_tpu_torch.solvers.pose import estimate_world_camera_pose
from velocity_tpu_torch.utils import profiling

F64 = torch.float64


@dataclass
class RunResult:
    """Everything a run produces, in analysis-friendly layout."""

    S: np.ndarray  # (n, 9) stats table (reference columns)
    B: np.ndarray  # (n, 14) car info [xyz, t_xyz(3:6), ecef(6:9), lla(9:12), t, frame#]
    track_px: np.ndarray  # (n, N, 2) tracked pixels (NaN where invalid)
    proj_px: np.ndarray  # (n, N, 2) reprojections (NaN where not in solve)
    valid: np.ndarray  # (n, N) track validity per frame
    plate_box: tuple
    roi_box: tuple
    camera: CameraInfo = None
    config: PipelineConfig = None
    first_gray: np.ndarray | None = None
    last_gray: np.ndarray | None = None
    timings: dict = field(default_factory=dict)

    @property
    def speed_kmh(self) -> float:
        return float(self.S[1:, 8].mean())

    @property
    def speed_std(self) -> float:
        return float(self.S[1:, 8].std())

    @property
    def residual_px(self) -> float:
        return float(self.S[1:, 3].mean())

    def smoothed(self, degree: int = 3):
        """(distance_fit_m, speed_fit_kmh): polynomial-smoothed curves."""
        return report.polyfit_speed(self.S, degree)


def _fit_plane(p3, valid):
    """Least-squares plane n . x = d through the valid structure points."""
    pts = p3[valid]
    c = pts.mean(axis=0)
    _u, _s, vt = np.linalg.svd(pts - c, full_matrices=False)
    n = vt[-1]
    return n, float(n @ c)


def _init_features_run(gray, box, max_corners, quality, block, k,
                       subpix_win, subpix_iters, subpix_eps):
    """Harris in the ROI ``box`` = (x0, x1, y0, y1) + subpixel refinement,
    on ``gray``'s device, read to the host in one copy. Returns (refined
    points (M, 2) f32 in image coordinates, validity (M,)), and adds the
    refinement's trip count (the most iterations a point ran) to the run's
    counter ``subpix.iterations``."""
    x0, x1, y0, y1 = box
    roi = gray[y0:y1, x0:x1]
    corners = good_features(roi, max_corners=max_corners, quality_level=quality,
                            block=block, k=k)
    offset = torch.tensor([x0, y0], dtype=corners.points.dtype, device=gray.device)
    pts = corners.points + offset
    refined, iters = _corner_subpix(gray, pts, half_win=subpix_win, max_iters=subpix_iters,
                                    eps=subpix_eps)
    f32 = torch.float32
    host = torch.cat([refined.to(f32), corners.valid[:, None].to(f32),
                      iters[:, None].to(f32)], dim=1).cpu().numpy()
    profiling.count("subpix.iterations", int(host[:, 3].max(initial=0)))
    return host[:, :2], host[:, 2] != 0


def _init_features(cfg: PipelineConfig, gray, q: np.ndarray):
    """Frame-0 features: (p (N, 2) f32, valid (N,), plate box, ROI box) on the
    host, with the plate corners in lanes 0..3."""
    tc = cfg.tracker
    shape = tuple(gray.shape)
    boxa = bounding_rect(q, shape, border=(0, 0))
    boxb = bounding_rect(q, shape, border=tc.roi_border)
    refined, cvalid = _init_features_run(
        gray, tuple(int(v) for v in boxb), tc.max_features - 4, tc.harris_quality,
        tc.harris_block, tc.harris_k, tc.subpix_window, tc.subpix_iters, tc.subpix_eps)
    N = tc.max_features
    p = np.zeros((N, 2), np.float32)
    valid = np.zeros(N, bool)
    p[0:4] = q
    valid[0:4] = True
    p[4:] = refined
    valid[4:] = cvalid
    return p, valid, boxa, boxb


def _init_geometry_solve(intr: Intrinsics, q, plate, p, solver_cfg: SolverConfig):
    """Frame-0 plate solve + plane backprojection -> (t0, p3, residual)."""
    pose0 = estimate_world_camera_pose(intr, q, plate, find_R=True, config=solver_cfg)
    pw2 = image_to_world_plane(intr, pose0.R, pose0.t, p)
    pw3 = torch.cat([pw2, torch.zeros((p.shape[0], 1), dtype=pw2.dtype)], dim=1)
    p3 = pw3 @ pose0.R + pose0.t
    return pose0.t, p3, pose0.residual_rms


def _init_geometry(cfg: PipelineConfig, cam: CameraInfo, q: np.ndarray, p: np.ndarray,
                   valid: np.ndarray, scale: float):
    """Frame-0 geometry on the host CPU in float64: the plane intersection of
    off-plate points is noise-amplifying, and this runs once per video."""
    intr64 = cam.intrinsics(scale=scale).to(dtype=F64)
    plate = torch.as_tensor(license_plate_points(cfg.plate_country), dtype=F64)
    t0, p3, res0 = _init_geometry_solve(
        intr64, torch.as_tensor(q, dtype=F64), plate, torch.as_tensor(p, dtype=F64),
        cfg.solver)
    p3 = p3.numpy().copy()
    p3[~valid] = 0.0
    return t0.numpy().astype(np.float64), p3, float(res0)


@dataclass
class Frame0:
    """Frame 0's state on the host: the points (N, 2) f32 with the plate
    corners in lanes 0..3, their validity, the solve's lanes ``vp`` (the
    valid ones inside the plate box), the plate and ROI boxes, and the plate
    geometry (f64): translation, structure and residual."""

    p: np.ndarray
    valid: np.ndarray
    vp: np.ndarray
    boxa: tuple
    boxb: tuple
    t0: np.ndarray
    p3: np.ndarray
    res0: float

    def carry(self, sdt, device):
        """((pts, vg, vp, t0), p3) on ``device``: the frame step's start
        state after the pyramids, and the structure; t0 and p3 in ``sdt``."""
        return ((torch.as_tensor(self.p, dtype=torch.float32, device=device),
                 torch.as_tensor(self.valid, device=device),
                 torch.as_tensor(self.vp, device=device),
                 torch.as_tensor(self.t0, dtype=sdt, device=device)),
                torch.as_tensor(self.p3, dtype=sdt, device=device))


def _init_frame0(cfg: PipelineConfig, cam: CameraInfo, im, q: np.ndarray, scale: float):
    """Frame 0's state from ``im`` (uint8 (H, W) on the device): features
    (span ``init.features``), then the pyramids, then the geometry on the
    host in f64 (span ``init.geometry``), so that the pyramids are queued on
    the card before the host solve. Returns (``Frame0``, pyr, spyr)."""
    with profiling.span("init.features"):
        p, valid, boxa, boxb = _init_features(cfg, im, q)
    pyr, spyr = frame_pyramids(im, cfg.tracker)
    with profiling.span("init.geometry"):
        t0, p3, res0 = _init_geometry(cfg, cam, q, p, valid, scale)
    return Frame0(p, valid, valid & inside_bbox(p, boxa), boxa, boxb, t0, p3, res0), pyr, spyr


class RunTables:
    """One run's host tables over ``n`` frames of ``N`` lanes: the car rows
    ``B`` (n, 14), the 9-column table ``S`` (its column 3 is the residual
    column ``res``), the tracked and reprojected pixels (n, N, 2) f32, NaN
    where none, the validity history and the stage-2 counts ``n2``."""

    def __init__(self, n: int, N: int):
        self.B = np.zeros((n, 14), np.float64)
        self.S = np.zeros((n, 9), np.float64)
        self.track_px = np.full((n, N, 2), np.nan, np.float32)
        self.proj_px = np.full_like(self.track_px, np.nan)
        self.valid_hist = np.zeros((n, N), bool)
        self.n2 = np.zeros(n)

    @property
    def res(self) -> np.ndarray:
        return self.S[:, 3]

    def start(self, f0: Frame0) -> RunTables:
        """Write frame 0's row: its translation, points and residual."""
        self.B[0, 0:3] = f0.t0
        self.record(0, f0.p, f0.valid)
        self.res[0] = f0.res0
        return self

    def record(self, i: int, pts, vg, proj=None, vp=None):
        """Frame i's points where ``vg`` (and reprojections where ``vp``)."""
        self.track_px[i, vg] = pts[vg]
        self.valid_hist[i] = vg
        if proj is not None:
            self.proj_px[i, vp] = proj[vp]

    def stats(self, proc: float, rows: int | None = None) -> np.ndarray:
        """The 9-column table of rows 0..rows-1 (all by default) from the car
        rows: frame, processing time ``proc``, live lanes, residual, dt,
        time, step, distance, speed (km/h)."""
        B = self.B
        n = len(B) if rows is None else rows
        S = np.zeros((n, 9), np.float64)
        dist = 0.0
        for i in range(n):
            dt = B[i, 12] - B[i - 1, 12] if i > 0 else np.nan
            dr = float(np.linalg.norm(B[i, 0:3] - B[i - 1, 0:3])) if i > 0 else 0.0
            dist += dr
            S[i] = (i, proc, self.valid_hist[i].sum(), self.res[i], dt, B[i, 12] - B[0, 12], dr,
                    dist, dr / dt * 3.6 if i > 0 and dt > 0 else np.nan)
        return S


def require_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; raises where it names CUDA and
    there is none (an entry point never carries on on the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device 'cuda' requested but CUDA is not available")
    return device


def resolve_annotation(video, annotation) -> Annotation:
    """The run's annotation: given, loaded from a path, or found beside ``video``."""
    if annotation is None:
        vpath = Path(video)
        return load_annotation(find_annotation(vpath, [vpath.parent.parent / "matlab",
                                                       vpath.parent]))
    if isinstance(annotation, Annotation):
        return annotation
    return load_annotation(annotation)


def resolve_start(cfg: PipelineConfig, ann: Annotation, start_frame) -> int:
    start = (start_frame if start_frame is not None else
             (cfg.start_frame if cfg.start_frame is not None else ann.start_frame))
    if start is None:
        raise ValueError("no start frame (annotation lacks one; pass start_frame)")
    return start


def open_reader(video, platform: str):
    """``video`` itself where it is a reader (``.info``,
    ``.frames(start, count, step)``, context manager), else the cv2
    ``VideoReader`` of that path."""
    if hasattr(video, "frames"):
        return video
    from velocity_tpu_torch.ingest.video import VideoReader

    return VideoReader(video, platform)


def frames_available(cam: CameraInfo, start: int, n: int, step: int) -> int:
    """``n`` cut to the frames the clip holds from ``start`` on."""
    if not cam.frame_count:
        return n
    avail = -(-(int(cam.frame_count) - start) // step)
    if avail <= 0:
        raise ValueError(f"start frame {start} beyond video ({cam.frame_count})")
    return min(n, avail)


def _captured_step(im, carry, p3, intr, cfg, solver_cfg, solver_dtype):
    """The driver's captured frame step for these inputs on a card (the
    non-lean capture, which the scan runner's segments share), or None on
    the CPU, where the driver steps eagerly."""
    if im.device.type != "cuda":
        return None
    return _graph_step(im, carry, p3, intr, cfg, solver_cfg, solver_dtype, False)


@dataclass
class _LoopState:
    """The per-frame loop's state after a frame: the step's carry (save the
    pyramids) and the structure on the device, the host copies read of its
    masks and points (None after the MSV frame of a lean run), and the
    re-seeded lanes awaiting promotion (the stills driver's)."""

    pts: torch.Tensor
    vg_dev: torch.Tensor
    vp_dev: torch.Tensor
    t: torch.Tensor
    p3: torch.Tensor
    vg: np.ndarray | None
    vp: np.ndarray | None
    pts_host: np.ndarray | None
    pending: np.ndarray


class SpeedEstimator:
    """The per-frame driver, on ``device`` ("cuda" or "cpu").

    ``fallback_matcher(im_prev, im_cur, pts, valid) -> (2, 3) affine`` (numpy
    uint8 frames, numpy points and mask) replaces the cv2 feature match of
    the rescue; without one the rescue needs ``cv2``.
    """

    def __init__(self, config: PipelineConfig = PipelineConfig(), device="cuda",
                 fallback_matcher=None):
        self.config = config
        self.device = require_device(device, "SpeedEstimator")
        self.tracker = ThreeStageTracker(config.tracker, fallback_matcher)

    # ------------------------------------------------------------ replenish
    def _replenish(self, gray, q, pts, vg, p3, t_abs, intr_np, min_live: int | None = None):
        """Refill dead lanes with fresh Harris corners back-projected onto the
        plane of the live structure; returns (pts, vg, p3, n_new).

        Long videos and the wide-baseline stills burst shed tracks faster
        than 20-frame clips, so their drivers re-seed dead lanes at window
        or frame boundaries. Detection runs around the current plate
        position (the tracked lanes 0..3) when the plate lanes are alive:
        the annotation ``q`` is frame-0 geometry and the car moves. Plate
        lanes themselves are never re-seeded: BA pins them as the metric
        scale anchor.
        """
        cfg = self.config
        live = int(vg.sum())
        if min_live is None:
            min_live = cfg.tracker.max_features // 2
        if live >= min_live or live < 3:
            return pts, vg, p3, 0
        q_now = pts[0:4] if bool(vg[0:4].all()) else q
        p_new, valid_new, _boxa, _boxb = _init_features(
            cfg, torch.as_tensor(gray).to(self.device), q_now)
        n_pl, d_pl = _fit_plane(p3, vg)
        fx, fy, cx, cy = intr_np
        dead = ~vg
        cand = valid_new & dead  # only fill lanes that are both free and found
        cand[:4] = False
        # ray of each candidate pixel in the current camera
        rx = (p_new[:, 0] - cx) / fx
        ry = (p_new[:, 1] - cy) / fy
        rays = np.stack([rx, ry, np.ones_like(rx)], axis=1)
        rays /= np.linalg.norm(rays, axis=1, keepdims=True)
        # p = s*ray - t_abs on the plane n.p = d  =>  s = (d + n.t)/(n.ray)
        denom = rays @ n_pl
        s = np.where(np.abs(denom) > 1e-9, (d_pl + n_pl @ t_abs) / denom, np.nan)
        p3_cand = s[:, None] * rays - t_abs[None, :]
        ok = cand & np.isfinite(p3_cand).all(axis=1) & (s > 0)
        pts = np.where(ok[:, None], p_new, pts)
        p3 = np.where(ok[:, None], p3_cand, p3)
        vg = vg | ok
        return pts, vg, p3, int(ok.sum())

    # ------------------------------------------------------------ frame step
    def _frame_step_with_fallback(self, pyr_prev, spyr_prev, im_dev, pts_dev, vg_dev, vp_dev,
                                  p3, intr, generator, sdt, prev_gray, gray, t_prev):
        """One ``fused_frame_step_pyr`` (on a card one replay of its captured
        graph, eagerly on the CPU) + the host feature-match rescue on
        tracking collapse: when stage 2 leaves <= ``min_affine_inliers``
        survivors, a full-frame match of ``prev_gray`` and ``gray`` (uint8,
        host) supplies the affine prior, and the fine stage and the pose
        solve run again, eagerly. The matcher is the tracker's
        ``fallback_matcher`` where one was given, else
        ``affine_from_feature_match`` (cv2) at half scale. Returns what
        ``fused_frame_step_pyr`` returns, T23 None where a replayed frame
        was not rescued (the graph does not keep it). A replay's outputs
        are the graph's buffers: read them before the next frame's step.
        """
        cfg = self.config
        carry = (pyr_prev, spyr_prev, pts_dev, vg_dev, vp_dev, t_prev)
        graph = _captured_step(im_dev, carry, p3, intr, cfg.tracker, cfg.solver, sdt)
        with profiling.span("step"):
            if graph is None:
                out = fused_frame_step_pyr(
                    pyr_prev, spyr_prev, im_dev, pts_dev, vg_dev, vp_dev,
                    p3, intr, generator, cfg.tracker, cfg.solver, sdt, t_prev)
            else:
                carry_out, rec = graph(im_dev, carry, p3, intr, generator)
                out = (*carry_out[:2], *rec, None)
                # the carry the caller passed may be the last replay's outputs,
                # which this replay overwrote: the rescue reads the previous
                # frame's state from the input buffers the replay read it from
                pyr_prev, spyr_prev, pts_dev, vg_dev, vp_dev, t_prev = graph.inputs[1]
        pyr_cur, spyr_cur, n2 = out[0], out[1], out[8]
        with profiling.span("frame.wait"):
            n2_host = int(n2)
        if n2_host > cfg.tracker.min_affine_inliers:
            return out
        with profiling.span("rescue"):
            matcher = self.tracker.fallback_matcher
            if matcher is None:
                from velocity_tpu_torch.ops.match import affine_from_feature_match

                matcher = partial(affine_from_feature_match, scale=0.5)
            pnp = pts_dev.cpu().numpy()
            vnp = vg_dev.cpu().numpy()
            if cfg.tracker.car_affine:
                # car-anchored rescue: search only around the tracked plate so
                # the match affine locks onto the car's motion group
                lo = pnp[0:4].min(axis=0)
                hi = pnp[0:4].max(axis=0)
                m = cfg.tracker.car_margin * float(np.linalg.norm(hi - lo))
                inbox = ((pnp[:, 0] >= lo[0] - m) & (pnp[:, 0] <= hi[0] + m)
                         & (pnp[:, 1] >= lo[1] - m) & (pnp[:, 1] <= hi[1] + m))
                vm = vnp & inbox
                vnp = vm if vm.sum() >= 4 else vnp
            T23 = torch.as_tensor(np.asarray(matcher(prev_gray, gray, pnp, vnp)),
                                  dtype=torch.float32, device=pts_dev.device)
            p_new, vg_new = _track_fine_p(pyr_prev, pyr_cur, pts_dev, vg_dev, T23, cfg.tracker)
            vp_new = vp_dev & vg_new
            t0 = (t_prev.to(sdt) if t_prev is not None else
                  torch.tensor([0.0, 0.0, 1.0], dtype=sdt, device=pts_dev.device))
            pose = estimate_world_camera_pose(
                intr, p_new.to(sdt), p3, t0=t0,
                R0=torch.eye(3, dtype=sdt, device=pts_dev.device), find_R=False,
                mask=vp_new, config=cfg.solver)
            return (pyr_cur, spyr_cur, p_new, vg_new, vp_new,
                    pose.t, pose.residual_rms, pose.p_proj, n2, T23)

    def _after_frame(self, st: _LoopState, tables: RunTables, i: int, n: int, im, q, intr_np):
        """The per-frame loop's work after frame i (``im``, on the device) is
        recorded: nothing here; the stills driver re-seeds and promotes
        lanes."""

    # ------------------------------------------------------------------- run
    @profiling.recorded
    def run(self, video, annotation=None, n_frames=None, start_frame=None,
            verbose=True, collect_images=True, lean: bool = False) -> RunResult:
        """Run the pipeline over ``video`` (a path or a reader, see
        ``open_reader``), one frame at a time.

        ``lean=True`` (the bench's run): each frame after the MSV frame is
        read from the device as one packed summary (one copy in place of
        five; a rescue reads what it reads); its track and reprojection
        history is not recorded (NaN, ``valid`` False). The trajectory and
        ``S[:, 2:]`` are those of ``lean=False`` where the solver is f32."""
        cfg = self.config
        n = n_frames if n_frames is not None else cfg.n_frames
        ann = resolve_annotation(video, annotation)
        start = resolve_start(cfg, ann, start_frame)
        with open_reader(video, cfg.platform) as vr:
            cam = vr.info
            n = frames_available(cam, start, n, cfg.read_speed)
            read = vr.prefetch if hasattr(vr, "prefetch") else vr.frames
            frames = ((fr.gray, slice(12, 14), (fr.time_s, fr.index))
                      for fr in read(start=start, count=n, step=cfg.read_speed))
            if verbose:
                print(f"Starting image processing on {video} ...")
            # native-4K annotation -> this video's resolution
            return self._run_frames(frames, cam, ann.q * cfg.native_scale, n, verbose,
                                    collect_images, lean)

    def _run_frames(self, frames, cam: CameraInfo, q, n: int, verbose: bool,
                    collect_images: bool, lean: bool = False) -> RunResult:
        """The per-frame drivers' loop over ``n`` ``frames``, each (gray uint8
        (H, W) on the host, the columns of ``B`` its reader fills, their
        values): frame 0's init, then one step a frame, the re-anchor at the
        MSV frame and ``_after_frame``."""
        from velocity_tpu_torch.pipeline.anchor import reanchor, write_back

        cfg = self.config
        dev = self.device
        sdt = F64 if cfg.solver.dtype == "float64" else torch.float32
        scale = cfg.native_scale
        intr = cam.intrinsics(scale=scale).to(dtype=sdt)
        intr_np = tuple(float(v) for v in intr[:4])  # fx, fy, cx, cy
        intr = intr.to(device=dev)
        tables = RunTables(n, cfg.tracker.max_features)
        B, S = tables.B, tables.S
        # one generator per run, drawn from in frame order, as the scan
        # runner's: the two give the same bits where no frame is rescued
        gen = torch.Generator(device=dev).manual_seed(0)
        t_wall0 = time.perf_counter()
        if verbose:
            print(report.header())

        first_gray = last_gray = None
        for i, (gray, cols, vals) in profiling.spans_over(enumerate(frames), "frame",
                                                          first="init"):
            tic = time.perf_counter()
            B[i, cols] = vals
            prev_gray, last_gray = last_gray, gray
            with profiling.span("frame.upload"):
                im = torch.as_tensor(gray).to(dev)

            if i == 0:
                first_gray = gray if collect_images else None
                f0, pyr, spyr = _init_frame0(cfg, cam, im, q, scale)
                tables.start(f0)
                carry, p3 = f0.carry(sdt, dev)
                st = _LoopState(*carry, p3, vg=f0.valid.copy(), vp=f0.vp, pts_host=f0.p,
                                pending=np.zeros(len(f0.p), bool))
                residual, n_tracks, dt, dr, dist = f0.res0, float(f0.valid.sum()), np.nan, 0.0, 0.0
            else:
                (pyr, spyr, st.pts, st.vg_dev, st.vp_dev,
                 st.t, res_dev, pproj, n2, _T23) = self._frame_step_with_fallback(
                    pyr, spyr, im, st.pts, st.vg_dev, st.vp_dev,
                    st.p3, intr, gen, sdt, prev_gray, gray, st.t)
                if lean and i > cfg.msv_frame:
                    packed = pack_summary(st.t, res_dev, st.vg_dev, n2).cpu().numpy()
                    packed = packed.astype(np.float64)
                    tnp, residual, n_tracks = packed[0:3], packed[3], packed[4]
                    st.vg = st.vp = None
                else:
                    st.vg = st.vg_dev.cpu().numpy()
                    st.vp = st.vp_dev.cpu().numpy()
                    proj = pproj.float().cpu().numpy()
                    tnp = st.t.cpu().numpy().astype(np.float64)
                    st.pts_host = st.pts.cpu().numpy()
                    tables.record(i, st.pts_host, st.vg, proj, st.vp)
                    residual, n_tracks = res_dev, float(st.vg.sum())
                dt = B[i, 12] - B[i - 1, 12]
                dr = float(np.linalg.norm(tnp + B[0, 0:3] - B[i - 1, 0:3]))
                dist = S[i - 1, 7] + dr
                B[i, 3:6] = tnp
                B[i, 0:3] = B[0, 0:3] + tnp
            S[i] = (i, 0.0, n_tracks, float(residual), dt, B[i, 12] - B[0, 12], dr, dist,
                    dr / dt * 3.6 if np.isfinite(dt) and dt > 0 else np.nan)

            if i == cfg.msv_frame:
                # scale transfer (once per video; host f64, see anchor.py)
                p3_new, t_abs, res_new = reanchor(
                    cfg, cam, scale, tables.track_px[: i + 1], st.vg, B,
                    st.t.cpu().numpy().astype(np.float64),
                    st.p3.cpu().numpy().astype(np.float64), q=np.asarray(q, np.float64))
                st.p3 = torch.as_tensor(p3_new, dtype=sdt, device=dev)
                st.t = write_back(tables, i, t_abs, res_new, st.t, per_frame=True)
                st.vp = st.vg.copy()
                st.vp_dev = torch.as_tensor(st.vp, device=dev)
            S[i, 1] = time.perf_counter() - tic
            if verbose:
                print(report.row(S[i]))
            self._after_frame(st, tables, i, n, im, q, intr_np)

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t_wall0
        if verbose:
            print(report.summary(S))
            print(f"Processed {n:g} images in {wall:.2f}s ({n / wall:.2f}fps)\n")
        return RunResult(
            S=S, B=B, track_px=tables.track_px, proj_px=tables.proj_px, valid=tables.valid_hist,
            plate_box=f0.boxa, roi_box=f0.boxb, camera=cam, config=cfg,
            first_gray=first_gray, last_gray=last_gray if collect_images else None,
            timings={"wall_s": wall, "fps": n / wall},
        )
