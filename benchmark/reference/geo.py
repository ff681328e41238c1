"""WGS-84 geodesy for the reference's georegistered positions (numpy, f64)."""

from __future__ import annotations

import numpy as np

A = 6378137.0  # semi-major axis (m)
F = 1.0 / 298.257223563
E2 = F * (2.0 - F)


def lla_to_ecef(lla: np.ndarray) -> np.ndarray:
    """[lat deg, lon deg, alt m] (..., 3) -> ECEF metres (..., 3)."""
    lat, lon = np.radians(lla[..., 0]), np.radians(lla[..., 1])
    alt = lla[..., 2]
    n = A / np.sqrt(1.0 - E2 * np.sin(lat) ** 2)
    return np.stack([(n + alt) * np.cos(lat) * np.cos(lon),
                     (n + alt) * np.cos(lat) * np.sin(lon),
                     (n * (1.0 - E2) + alt) * np.sin(lat)], axis=-1)


def ecef_from_ned(lat_deg: float, lon_deg: float) -> np.ndarray:
    """(3, 3) whose columns are north, east and down in ECEF at a point."""
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    sl, cl, so, co = np.sin(lat), np.cos(lat), np.sin(lon), np.cos(lon)
    north = np.array([-sl * co, -sl * so, cl])
    east = np.array([-so, co, 0.0])
    down = np.array([-cl * co, -cl * so, -sl])
    return np.stack([north, east, down], axis=1)


def ned_to_ecef(ned: np.ndarray, origin_lla: np.ndarray) -> np.ndarray:
    """NED metres (n, 3) about ``origin_lla`` -> ECEF metres (n, 3)."""
    return ned @ ecef_from_ned(origin_lla[0], origin_lla[1]).T + lla_to_ecef(origin_lla)
