"""Metric license-plate geometry — the scale anchor of the whole pipeline.

Parity: reference ``worldPointsLicensePlate`` (reference utils/common.py:150-156).
Corner order is clockwise starting top-right: (+,-), (+,+), (-,+), (-,-) times
half-size, matching the hand-annotation click order (matlab/runExample.m:56-62).
"""

from __future__ import annotations

import numpy as np

# (width, height) in meters
PLATE_SIZES = {
    "Chile": (0.3725, 0.1275),
    "EU": (0.520, 0.110),
}

_CORNER_SIGNS = np.array(
    [[1, -1, 0], [1, 1, 0], [-1, 1, 0], [-1, -1, 0]], dtype=np.float64
)


def license_plate_points(country: str = "EU", dtype=np.float32) -> np.ndarray:
    """(4, 3) plate-corner coordinates in meters on the z=0 plate plane."""
    w, h = PLATE_SIZES.get(country, PLATE_SIZES["EU"])
    size = np.array([w, h, 0.0], dtype=np.float64)
    return (_CORNER_SIGNS * size / 2).astype(dtype)
