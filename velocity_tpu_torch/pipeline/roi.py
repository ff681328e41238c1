"""Host-side ROI helpers (init-time, numpy).

Parity: reference ``boundingRect``/``insidebbox`` (reference utils/images.py:9-27),
including the quirky >=1 lower clamp and the (x0, x1, y0, y1) return order.
"""

from __future__ import annotations

import numpy as np


def bounding_rect(points: np.ndarray, imshape, border=(0, 0)):
    """Integer bounding box (x0, x1, y0, y1) of points, expanded by ``border``.

    Uses cv2.boundingRect's float-point convention: floor on mins and
    width = ceil(max) - floor(min). Clamped to [1, width] x [1, height] like
    the reference.
    """
    xmin = int(np.floor(points[:, 0].min()))
    ymin = int(np.floor(points[:, 1].min()))
    w = int(np.ceil(points[:, 0].max())) - xmin
    h = int(np.ceil(points[:, 1].max())) - ymin
    x0, y0 = xmin - border[0], ymin - border[1]
    x1, y1 = xmin + w + border[0], ymin + h + border[1]
    x0 = max(x0, 1)
    y0 = max(y0, 1)
    x1 = min(x1, imshape[1])
    y1 = min(y1, imshape[0])
    return x0, x1, y0, y1


def inside_bbox(points, box):
    """Strict-inequality point-in-box mask; box = (x0, x1, y0, y1)."""
    x0, x1, y0, y1 = box
    p = np.asarray(points)
    return (p[:, 0] > x0) & (p[:, 0] < x1) & (p[:, 1] > y0) & (p[:, 1] < y1)
