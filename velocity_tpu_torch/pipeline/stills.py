"""Stills-burst speed estimation (the reference's isVideo=False path,
vidExample.py:25-29,92-95) plus EXIF/GPS georegistration (the MATLAB driver's
extra, runExample.m:156-159).

Torch twin of ``velocity_tpu/pipeline/stills.py``. Timing comes from EXIF
DateTimeOriginal + SubSecTimeOriginal per image; the camera track is
georegistered to ECEF/NED about the first image's GPS fix. The loop is the
per-frame driver's (``pipeline/speedest.py``) with two additions for the
wide-baseline burst: dead lanes are re-seeded on every frame from the MSV
frame on (``SpeedEstimator._replenish``), and a re-seeded lane joins the
pose solve once N-ray triangulation from real baseline places it inside a
plausible depth band (``_promote_pending``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from velocity_tpu_torch.config import PipelineConfig
from velocity_tpu_torch.geometry.geodesy import ecef_to_lla, ecef_to_ned, lla_to_ecef, ned_to_ecef
from velocity_tpu_torch.pipeline import report
from velocity_tpu_torch.pipeline.anchor import reanchor
from velocity_tpu_torch.pipeline.roi import inside_bbox
from velocity_tpu_torch.pipeline.speedest import F64, RunResult, SpeedEstimator, resolve_annotation
from velocity_tpu_torch.pipeline.tracker import frame_pyramids
from velocity_tpu_torch.solvers.triangulate import nray_intercept_masked_np
from velocity_tpu_torch.utils import profiling


def open_stills(images, platform: str):
    """``images`` itself where it is a reader (``.info``, ``.paths``,
    ``.frames()`` yielding (index, gray, llat), ``.yaw_deg(index)``), else
    the cv2/PIL ``StillsReader`` of that list of paths."""
    if hasattr(images, "frames"):
        return images
    from velocity_tpu_torch.ingest.stills import StillsReader

    return StillsReader(images, platform)


class StillsSpeedEstimator(SpeedEstimator):
    """Speed estimation over an ordered JPG burst with EXIF timing/GPS, on
    ``device`` ("cuda" or "cpu").

    Forces the car-anchored affine prior (TrackerConfig.car_affine): the
    sharp wide-baseline burst has two motion groups, and the background
    dominates global consensus — see the config field's rationale.
    """

    def __init__(self, config: PipelineConfig = PipelineConfig(), device="cuda",
                 fallback_matcher=None):
        if not config.tracker.car_affine:
            config = dataclasses.replace(
                config, tracker=dataclasses.replace(config.tracker, car_affine=True))
        super().__init__(config, device, fallback_matcher)

    def _promote_pending(self, intr_np, track_px, B, valid_hist, pending, p3, t, vp, i):
        """Triangulate the pending (re-seeded) lanes from their observations
        since the MSV frame; those that land inside (0.25, 4) x the median
        live depth join the solve. Returns (p3, vp, pending, n_promoted)
        (host numpy, f64 structure)."""
        first = self.config.msv_frame
        z_live = (p3[vp] + t)[:, 2]
        med = float(np.median(z_live)) if vp.any() else 10.0
        p3_tri, okt = nray_intercept_masked_np(
            intr_np,
            track_px[first : i + 1],
            B[first : i + 1, 0:3] - B[0, 0:3],
            valid_hist[first : i + 1] & pending[None, :],
            depth_range=(0.25 * med, 4.0 * med),
        )
        promote = pending & okt
        if not promote.any():
            return p3, vp, pending, 0
        p3 = p3.copy()
        p3[promote] = p3_tri[promote]
        return p3, vp | promote, pending & ~promote, int(promote.sum())

    @profiling.recorded
    def run(self, images, annotation=None, verbose: bool = True, collect_images: bool = True,
            georegister: bool = True) -> RunResult:
        """Run the pipeline over ``images``: a list of still paths or a
        reader (see ``open_stills``)."""
        cfg = self.config
        dev = self.device
        sdt = F64 if cfg.solver.dtype == "float64" else torch.float32

        reader = open_stills(images, cfg.platform)
        cam = reader.info
        ann = resolve_annotation(reader.paths[0], annotation)
        scale = cfg.native_scale
        q = ann.q * scale
        intr = cam.intrinsics(scale=scale).to(dtype=sdt, device=dev)
        intr_np = tuple(float(v) for v in (intr.fx, intr.fy, intr.cx, intr.cy))
        n = len(reader.paths)
        N = cfg.tracker.max_features

        B = np.zeros((n, 14), np.float64)
        S = np.zeros((n, 9), np.float64)
        track_px = np.full((n, N, 2), np.nan, np.float32)
        proj_px = np.full((n, N, 2), np.nan, np.float32)
        valid_hist = np.zeros((n, N), bool)

        pending = np.zeros(N, bool)  # replenished lanes awaiting triangulation
        # one generator per run, drawn from in frame order, as the driver's
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        t_wall0 = time.perf_counter()
        if verbose:
            print(f"Starting image processing on {n} stills ...")
            print(report.header())

        first_gray = last_gray = None
        for i, gray, llat in profiling.spans_over(reader.frames(), "frame", first="init"):
            tic = time.perf_counter()
            if llat is not None:
                B[i, 9:13] = llat
            B[i, 13] = i
            prev_gray = last_gray
            last_gray = gray
            with profiling.span("frame.upload"):
                im_dev = torch.as_tensor(gray).to(dev)

            if i == 0:
                first_gray = gray if collect_images else None
                with profiling.span("init.features"):
                    p, valid, boxa, boxb = self._init_features(im_dev, q)
                pyr_prev, spyr_prev = frame_pyramids(im_dev, cfg.tracker)
                with profiling.span("init.geometry"):
                    t_np, p3_np, res0 = self._init_geometry(cam, q, p, valid, scale)
                t = torch.as_tensor(t_np, dtype=sdt, device=dev)
                p3 = torch.as_tensor(p3_np, dtype=sdt, device=dev)
                residuals = res0
                B[0, 0:3] = t_np
                vg = valid.copy()
                vp = valid & inside_bbox(p, boxa)
                pts_dev = torch.as_tensor(p, dtype=torch.float32, device=dev)
                vg_dev = torch.as_tensor(vg, device=dev)
                vp_dev = torch.as_tensor(vp, device=dev)
                dt = np.nan
                dr = 0.0
                dist = 0.0
                t0_time = B[0, 12]
                p_proj_frame = None
            else:
                (pyr_prev, spyr_prev, pts_dev, vg_dev, vp_dev,
                 t, residuals, pproj_dev, _n2, _T23) = self._frame_step_with_fallback(
                    pyr_prev, spyr_prev, im_dev, pts_dev, vg_dev, vp_dev,
                    p3, intr, gen, sdt, prev_gray, gray, t)
                vg = vg_dev.cpu().numpy()
                vp = vp_dev.cpu().numpy()
                p_proj_frame = pproj_dev.float().cpu().numpy()

                dt = B[i, 12] - B[i - 1, 12]
                tnp = t.cpu().numpy().astype(np.float64)
                dr = float(np.linalg.norm(tnp + B[0, 0:3] - B[i - 1, 0:3]))
                dist += dr
                B[i, 3:6] = tnp
                B[i, 0:3] = B[0, 0:3] + tnp

            pnp = pts_dev.cpu().numpy()
            track_px[i, vg] = pnp[vg]
            valid_hist[i] = vg
            if p_proj_frame is not None:
                proj_px[i, vp] = p_proj_frame[vp]

            if i == cfg.msv_frame:
                p3_new, t_abs, res_new = reanchor(
                    cfg, cam, scale, track_px[: i + 1], vg, B,
                    t.cpu().numpy().astype(np.float64), p3.cpu().numpy().astype(np.float64),
                    q=np.asarray(q, np.float64))
                if t_abs is not None:
                    B[: i + 1, 0:3] = t_abs
                    B[: i + 1, 3:6] = t_abs - t_abs[0]
                    t = torch.as_tensor(t_abs[-1] - t_abs[0], dtype=sdt, device=dev)
                    # rewrite the rows already recorded in the new gauge;
                    # this frame's own row below keeps the step it measured
                    # before the re-anchor, as in the JAX driver
                    dist = 0.0
                    for r in range(i + 1):
                        drr = (float(np.linalg.norm(B[r, 0:3] - B[r - 1, 0:3]))
                               if r > 0 else 0.0)
                        dist += drr
                        S[r, 6] = drr
                        S[r, 7] = dist
                        dtr = S[r, 4]
                        S[r, 8] = (drr / dtr * 3.6
                                   if r > 0 and np.isfinite(dtr) and dtr > 0 else np.nan)
                        if res_new is not None:
                            S[r, 3] = res_new[r]
                p3 = torch.as_tensor(p3_new, dtype=sdt, device=dev)
                vp = vg.copy()
                vp_dev = torch.as_tensor(vp, device=dev)

            S[i, :] = (
                i, time.perf_counter() - tic, float(vg.sum()), float(residuals), dt,
                B[i, 12] - t0_time, dr, dist,
                dr / dt * 3.6 if np.isfinite(dt) and dt > 0 else np.nan,
            )
            if verbose:
                print(report.row(S[i]))

            # replenish after the scale transfer: the ~2 m/frame burst
            # baseline sheds tracks far faster than video. New lanes are
            # tracked at once but join the pose solve (vp) only after N-ray
            # triangulation from real baseline: the plane-seeded depth is
            # provisional, and static-background corners seeded at car depth
            # would drag the solve toward zero motion.
            if cfg.msv_frame <= i < n - 1:
                with profiling.span("replenish"):
                    p_r, vg_r, p3_r, n_new = self._replenish(
                        im_dev, q, pnp, vg, p3.cpu().numpy().astype(np.float64),
                        t.cpu().numpy().astype(np.float64), intr_np)
                if n_new:
                    pending |= vg_r & ~vg
                    vg = vg_r
                    pts_dev = torch.as_tensor(p_r, dtype=torch.float32, device=dev)
                    vg_dev = torch.as_tensor(vg, device=dev)
                    p3 = torch.as_tensor(p3_r, dtype=sdt, device=dev)
                    track_px[i, vg] = p_r[vg]
                    valid_hist[i] = vg
            pending &= vg
            if i > cfg.msv_frame and pending.any():
                with profiling.span("promote"):
                    p3_np2, vp, pending, n_prom = self._promote_pending(
                        intr_np, track_px, B, valid_hist, pending,
                        p3.cpu().numpy().astype(np.float64), t.cpu().numpy().astype(np.float64),
                        vp, i)
                if n_prom:
                    p3 = torch.as_tensor(p3_np2, dtype=sdt, device=dev)
                    vp_dev = torch.as_tensor(vp, device=dev)

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t_wall0
        if georegister and np.any(B[:, 9] != 0):
            with profiling.span("georegister"):
                georegister_track(B, yaw_deg=reader.yaw_deg(0))
        if verbose:
            print(report.summary(S))
            print(f"Processed {n:g} images in {wall:.2f}s ({n / wall:.2f}fps)\n")

        return RunResult(
            S=S, B=B, track_px=track_px, proj_px=proj_px, valid=valid_hist,
            plate_box=boxa, roi_box=boxb, camera=cam, config=cfg,
            first_gray=first_gray, last_gray=last_gray if collect_images else None,
            timings={"wall_s": wall, "fps": n / wall},
        )


def georegister_track(B: np.ndarray, yaw_deg: float | None = None):
    """Georegister the SfM track to Earth coordinates (in place).

    Parity with the MATLAB driver (matlab/runExample.m:49-50, 156-159):
      * camera GPS LLA fixes (B[:, 9:12]) -> ECEF -> NED about image 0;
      * true-north camera heading from EXIF GPSImgDirection + magnetic
        declination (2.56 deg, runExample.m:49-50) rotates the camera frame
        into NED (camera axes map to NED by the cam2ned permutation when the
        camera faces north, common.py:159);
      * the SfM car track B[:, 0:3] (camera-0 frame, metric) is rotated into
        NED, hung off image 0's fix, and exported as ECEF (B[:, 6:9]) and LLA
        (B[:, 9:12], replacing the raw GPS input, which is consumed here).

    Returns (cam_ned, car_ned): the cameras' GPS track and the car's SfM
    track, both in the image-0 NED frame — the quantities the MATLAB driver
    plots. Host numpy, a copy of the JAX package's function.
    """
    origin = B[0, 9:12].copy()
    cam_ecef = lla_to_ecef(B[:, 9:12])
    cam_ned = ecef_to_ned(cam_ecef, origin)

    # camera frame -> NED: cam2ned permutation (N=z_cam, E=x_cam, D=y_cam)
    # then heading rotation about Down by the true-north yaw
    perm = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    psi = np.deg2rad(yaw_deg) if yaw_deg is not None else 0.0
    c, s = np.cos(psi), np.sin(psi)
    R_yaw = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    car_ned = (R_yaw @ perm @ B[:, 0:3].T).T  # relative to camera 0
    car_ecef = ned_to_ecef(car_ned, origin)
    B[:, 6:9] = car_ecef
    B[:, 9:12] = ecef_to_lla(car_ecef)
    return cam_ned, car_ned
