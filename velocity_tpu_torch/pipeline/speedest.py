"""Run results and the frame-0 initialisation of the speed pipeline.

Torch twin of the parts of ``velocity_tpu/pipeline/speedest.py`` that the
scan path uses: ``RunResult``, ``_fit_plane``, the frame-0 feature init
(Harris in the plate ROI + subpixel refinement, on the device) and the
frame-0 geometry (6-DoF plate solve + plane backprojection, on the host CPU
in float64, as the JAX design keeps it). The per-frame driver
(``SpeedEstimator``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from velocity_tpu_torch.camera.database import CameraInfo
from velocity_tpu_torch.config import PipelineConfig, SolverConfig
from velocity_tpu_torch.geometry.plate import license_plate_points
from velocity_tpu_torch.geometry.projection import Intrinsics, image_to_world_plane
from velocity_tpu_torch.ops.harris import corner_subpix, good_features
from velocity_tpu_torch.pipeline.roi import bounding_rect
from velocity_tpu_torch.solvers.pose import estimate_world_camera_pose

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
        from velocity_tpu_torch.pipeline.report import polyfit_speed

        return polyfit_speed(self.S, degree)


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
    on ``gray``'s device. Returns (refined points (M, 2) in image
    coordinates, validity (M,))."""
    x0, x1, y0, y1 = box
    roi = gray[y0:y1, x0:x1]
    corners = good_features(roi, max_corners=max_corners, quality_level=quality,
                            block=block, k=k)
    offset = torch.tensor([x0, y0], dtype=corners.points.dtype, device=gray.device)
    pts = corners.points + offset
    refined = corner_subpix(gray, pts, half_win=subpix_win, max_iters=subpix_iters,
                            eps=subpix_eps)
    return refined, corners.valid


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
    p[4:] = refined.cpu().numpy()
    valid[4:] = cvalid.cpu().numpy()
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
