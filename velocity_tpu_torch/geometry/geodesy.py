"""Geodetic conversions for GPS/EXIF georegistration of camera tracks.

The reference's MATLAB driver georegisters the camera track from EXIF GPS via
``lla2ecef``/``ecef2ned`` (matlab/runExample.m:156-159) using MATLAB toolbox
builtins; these are the standalone WGS-84 equivalents. Pure numpy (host-side,
not perf-critical). A copy of ``velocity_tpu/geometry/geodesy.py``.
"""

from __future__ import annotations

import numpy as np

# WGS-84 ellipsoid
WGS84_A = 6378137.0  # semi-major axis (m)
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)  # first eccentricity squared


def lla_to_ecef(lla):
    """Geodetic [lat(deg), lon(deg), alt(m)] (..., 3) -> ECEF meters (..., 3)."""
    lla = np.asarray(lla, dtype=np.float64)
    lat = np.radians(lla[..., 0])
    lon = np.radians(lla[..., 1])
    alt = lla[..., 2]
    sl, cl = np.sin(lat), np.cos(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    x = (n + alt) * cl * np.cos(lon)
    y = (n + alt) * cl * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + alt) * sl
    return np.stack([x, y, z], axis=-1)


def ecef_to_lla(ecef, iters: int = 5):
    """ECEF meters (..., 3) -> geodetic [lat(deg), lon(deg), alt(m)] (..., 3).

    Iterative (Bowring-style) solution; 5 iterations gives sub-mm accuracy.
    """
    ecef = np.asarray(ecef, dtype=np.float64)
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(iters):
        sl = np.sin(lat)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
        alt = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + alt)))
    sl = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    alt = p / np.cos(lat) - n
    return np.stack([np.degrees(lat), np.degrees(lon), alt], axis=-1)


def ned_rotation(lat_deg: float, lon_deg: float) -> np.ndarray:
    """Rotation matrix R such that ``v_ned = R @ v_ecef`` at the given origin."""
    lat = np.radians(lat_deg)
    lon = np.radians(lon_deg)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array(
        [
            [-sl * co, -sl * so, cl],
            [-so, co, 0.0],
            [-cl * co, -cl * so, -sl],
        ]
    )


def ecef_to_ned(ecef, origin_lla):
    """ECEF meters (..., 3) -> local NED meters (..., 3) about ``origin_lla``."""
    origin_ecef = lla_to_ecef(np.asarray(origin_lla, dtype=np.float64))
    R = ned_rotation(origin_lla[0], origin_lla[1])
    d = np.asarray(ecef, dtype=np.float64) - origin_ecef
    return d @ R.T


def ned_to_ecef(ned, origin_lla):
    """Local NED meters (..., 3) about ``origin_lla`` -> ECEF meters (..., 3)."""
    origin_ecef = lla_to_ecef(np.asarray(origin_lla, dtype=np.float64))
    R = ned_rotation(origin_lla[0], origin_lla[1])
    return np.asarray(ned, dtype=np.float64) @ R + origin_ecef
