"""The 9-column per-frame report table — the reference's de-facto output contract
(vidExample.py:51-74,165,177-178)."""

from __future__ import annotations

import numpy as np

HEADER_NAMES = (
    "image", "procTime", "pointTracks", "metric", "dt", "time", "dx", "distance", "speed",
)
HEADER_UNITS = ("#", "(s)", "#", "(pixels)", "(s)", "(s)", "(m)", "(m)", "(km/h)")
_ROW_FMT = "{:13g}{:13.3f}{:13g}{:13.3f}{:13.3f}{:13.3f}{:13.2f}{:13.2f}{:13.1f}"


def header() -> str:
    return ("\n" + "%13s" * 9) * 2 % (HEADER_NAMES + HEADER_UNITS)


def row(values) -> str:
    return _ROW_FMT.format(*[float(v) for v in values])


def summary(S: np.ndarray) -> str:
    speeds = S[1:, 8]
    res = S[1:, 3]
    return (
        f"\nSpeed = {speeds.mean():.2f} +/- {speeds.std():.2f} km/h"
        f"\nRes = {res.mean():.3f} pixels"
    )


def polyfit_speed(S: np.ndarray, degree: int = 3):
    """Polynomial-smoothed distance/speed curves.

    The MATLAB driver fits the cumulative-distance-vs-time curve with a
    polynomial and differentiates it analytically for a smooth speed trace
    (reference matlab/runExample.m:185-190); the Python reference never
    ported this. Returns (distance_fit_m, speed_fit_kmh) over S's time rows.
    """
    t = S[:, 5]
    d = S[:, 7]
    ok = np.isfinite(t) & np.isfinite(d)
    if ok.sum() < degree + 1:
        return d.copy(), S[:, 8].copy()
    c = np.polyfit(t[ok], d[ok], degree)
    dist_fit = np.polyval(c, t)
    speed_fit = np.polyval(np.polyder(c), t) * 3.6
    return dist_fit, speed_fit
