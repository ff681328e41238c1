"""The plain reference: what a clip's answers should be, worked out from the
scene alone, and the numbers that compare the program's answers with it.

The scene is exact: every textured point lies on the car's plane, the
camera is static and the car moves without turning. So the reference needs
no tracker of its own. A point that the program found on frame 0 lies on
the plane, and its true image in frame i is the plane's homography into
frame i applied to it (``truth.plane_to_image``); the car's position in the
camera frame is ``truth.t_cam``; its speed is ``truth.speed_kmh``; with a
GPS fix and a heading, its Earth position follows from that position by the
stills' georegistration (``geo.py``). The reference reads the program's
answers only to judge them: the frame-0 points are where the tracks start.

Numbers (each the worst over a run's clips):

- ``track_err_px``: the median, over the tracks valid from frame 0 through
  frame i and over frames 1..msv, of the distance in pixels between the
  tracked point and its true image. Frames 1..msv are the ones whose
  history every driver returns (a lean run keeps no track history after the
  MSV frame; the stills and long-video drivers re-seed lanes only from the
  MSV frame on).
- ``track_err_p99_px``, ``track_err_max_px``: the same distances' 99th
  percentile and maximum.
- ``traj_err_pct``: the largest distance, over frames 1.., between the
  program's car position ``B[:, 0:3]`` and the true one, in percent of the
  true distance from the camera. It holds the pose LM, the re-anchor
  and, in a long video, the BA refinement.
- ``frame_speed_err_pct``: the largest per-frame speed error (``S[:, 8]``)
  in percent of the true speed.
- ``speed_err_pct``: the clip's reported speed (the mean of ``S[1:, 8]``)
  against the true speed, in percent.
- ``residual_px``: the reported mean residual (``S[1:, 3]``); the true
  geometry reprojects to within the sensor noise.
- ``ecef_err_m`` (with a GPS fix): the largest distance between the
  georegistered car position ``B[:, 6:9]`` and the true one, in metres.
- ``missing``: 1 where an answer is absent (too few frames, a frame that
  was not processed, which leaves its index ``B[:, 13]`` unset, or a
  position or a speed that is not finite), else 0.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import geo

NUMBERS = ("track_err_px", "track_err_p99_px", "track_err_max_px", "traj_err_pct",
           "frame_speed_err_pct", "speed_err_pct", "residual_px", "ecef_err_m", "missing")


def true_tracks(truth, p0: np.ndarray, frames) -> np.ndarray:
    """(len(frames), M, 2): the true images in ``frames`` of the frame-0
    points ``p0`` (M, 2), float64."""
    H = truth.plane_to_image
    plane = np.concatenate([p0, np.ones((len(p0), 1))], axis=1) @ np.linalg.inv(H[0]).T
    out = []
    for i in frames:
        q = plane @ H[i].T
        out.append(q[:, :2] / q[:, 2:3])
    return np.stack(out) if out else np.zeros((0, len(p0), 2))


def true_ecef(truth, gps_fix, yaw_deg: float) -> np.ndarray:
    """(n, 3) ECEF of the car: its camera-frame positions turned into NED by
    the camera's heading (camera z north and x east when facing north),
    hung off the camera's fix."""
    perm = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    psi = np.radians(yaw_deg)
    c, s = np.cos(psi), np.sin(psi)
    R_yaw = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    ned = truth.t_cam @ (R_yaw @ perm).T
    return geo.ned_to_ecef(ned, np.asarray(gps_fix, np.float64))


def _track_errors(ans: dict, truth, msv: int) -> np.ndarray:
    track, valid = ans["track_px"], ans["valid"]
    last = min(msv, len(track) - 1)
    alive = valid[0].copy()
    errs = []
    for i in range(1, last + 1):
        alive &= valid[i]
        if not alive.any():
            break
        want = true_tracks(truth, track[0][alive].astype(np.float64), [i])[0]
        errs.append(np.linalg.norm(track[i][alive].astype(np.float64) - want, axis=1))
    return np.concatenate(errs) if errs else np.zeros(0)


def readings(ans: dict, truth, n_frames: int, msv: int, gps=None) -> dict:
    """The numbers of one clip's answers (``gps``: (fix, yaw) of a burst)."""
    B, S = ans["B"], ans["S"]
    out = {k: 0.0 for k in NUMBERS}
    if (len(B) < n_frames or not np.array_equal(B[:n_frames, 13], np.arange(n_frames))
            or not np.isfinite(B[:n_frames, 0:3]).all()
            or not np.isfinite(S[1:n_frames, 8]).all()):
        out["missing"] = 1.0
        for k in NUMBERS[:-1]:
            out[k] = float("inf")
        return out
    e = _track_errors(ans, truth, msv)
    if len(e) == 0:
        out["missing"] = 1.0
        e = np.array([np.inf])
    out["track_err_px"] = float(np.median(e))
    out["track_err_p99_px"] = float(np.percentile(e, 99))
    out["track_err_max_px"] = float(e.max())
    t = truth.t_cam[:n_frames]
    d = np.linalg.norm(B[1:n_frames, 0:3] - t[1:], axis=1) / np.linalg.norm(t[1:], axis=1)
    out["traj_err_pct"] = float(100 * d.max())
    v = truth.speed_kmh
    out["frame_speed_err_pct"] = float(100 * np.abs(S[1:n_frames, 8] - v).max() / v)
    out["speed_err_pct"] = float(100 * abs(S[1:n_frames, 8].mean() - v) / v)
    out["residual_px"] = float(S[1:n_frames, 3].mean())
    if gps is not None:
        want = true_ecef(truth, *gps)[:n_frames]
        out["ecef_err_m"] = float(np.linalg.norm(B[:n_frames, 6:9] - want, axis=1).max())
    return out


def worst(per_clip: list[dict]) -> dict:
    """Each number's worst (largest) reading over the clips."""
    return {k: max(r[k] for r in per_clip) for k in NUMBERS} if per_clip else {}
