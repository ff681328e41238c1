"""Stills-burst speed estimation (the reference's isVideo=False path,
vidExample.py:25-29,92-95) plus EXIF/GPS georegistration (the MATLAB driver's
extra, runExample.m:156-159).

Torch twin of ``velocity_tpu/pipeline/stills.py``. Timing comes from EXIF
DateTimeOriginal + SubSecTimeOriginal per image; the camera track is
georegistered to ECEF/NED about the first image's GPS fix. The loop is the
per-frame driver's (``SpeedEstimator._run_frames`` in
``pipeline/speedest.py``); after each frame (``_after_frame``) come two
additions for the wide-baseline burst: dead lanes are re-seeded on every frame from the MSV
frame on (``SpeedEstimator._replenish``), and a re-seeded lane joins the
pose solve once N-ray triangulation from real baseline places it inside a
plausible depth band (``_promote_pending``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from velocity_tpu_torch.config import PipelineConfig
from velocity_tpu_torch.geometry.geodesy import ecef_to_lla, ecef_to_ned, lla_to_ecef, ned_to_ecef
from velocity_tpu_torch.pipeline.speedest import RunResult, SpeedEstimator, resolve_annotation
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


def _still_row(item):
    """A still of ``open_stills``'s reader as the per-frame loop takes it:
    (gray, columns of ``B``, values): its EXIF GPS fix and time (9:13)
    where it has them, and its index (13)."""
    i, gray, llat = item
    return (gray, slice(9, 14), (*llat, i)) if llat is not None else (gray, slice(13, 14), (i,))


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

    def _after_frame(self, st, tables, i, n, im, q, intr_np):
        """Replenish after the scale transfer: the ~2 m/frame burst baseline
        sheds tracks far faster than video. New lanes are tracked at once
        but join the pose solve (vp) only after N-ray triangulation from
        real baseline: the plane-seeded depth is provisional, and
        static-background corners seeded at car depth would drag the solve
        toward zero motion."""
        cfg = self.config
        dev = self.device
        if cfg.msv_frame <= i < n - 1:
            with profiling.span("replenish"):
                p_r, vg_r, p3_r, n_new = self._replenish(
                    im, q, st.pts_host, st.vg, st.p3.cpu().numpy().astype(np.float64),
                    st.t.cpu().numpy().astype(np.float64), intr_np)
            if n_new:
                st.pending |= vg_r & ~st.vg
                st.vg = vg_r
                st.pts = torch.as_tensor(p_r, dtype=torch.float32, device=dev)
                st.vg_dev = torch.as_tensor(st.vg, device=dev)
                st.p3 = torch.as_tensor(p3_r, dtype=st.p3.dtype, device=dev)
                tables.record(i, p_r, st.vg)
        st.pending &= st.vg
        if i > cfg.msv_frame and st.pending.any():
            with profiling.span("promote"):
                p3_np, st.vp, st.pending, n_prom = self._promote_pending(
                    intr_np, tables.track_px, tables.B, tables.valid_hist, st.pending,
                    st.p3.cpu().numpy().astype(np.float64),
                    st.t.cpu().numpy().astype(np.float64), st.vp, i)
            if n_prom:
                st.p3 = torch.as_tensor(p3_np, dtype=st.p3.dtype, device=dev)
                st.vp_dev = torch.as_tensor(st.vp, device=dev)

    @profiling.recorded
    def run(self, images, annotation=None, verbose: bool = True, collect_images: bool = True,
            georegister: bool = True) -> RunResult:
        """Run the pipeline over ``images``: a list of still paths or a
        reader (see ``open_stills``)."""
        cfg = self.config
        reader = open_stills(images, cfg.platform)
        ann = resolve_annotation(reader.paths[0], annotation)
        n = len(reader.paths)
        if verbose:
            print(f"Starting image processing on {n} stills ...")
        res = self._run_frames(map(_still_row, reader.frames()), reader.info,
                               ann.q * cfg.native_scale, n, verbose, collect_images)
        if georegister and np.any(res.B[:, 9] != 0):
            with profiling.span("georegister"):
                georegister_track(res.B, yaw_deg=reader.yaw_deg(0))
        return res


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
