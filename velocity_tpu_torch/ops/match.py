"""Full-frame feature-match rescue for tracking collapse (large motion).

Copy of ``velocity_tpu/ops/match.py`` (numpy and cv2, no device code): the
reference's ``estimateAffine2D_SURF``, run when the coarse KLT stages leave
too few survivors. SIFT (preferred) or ORB stand in for SURF: detect in a
growing ROI around the last known points, ratio-test match against the full
next frame, robust-fit a 2x3 affine. The steady-state tracker never calls it.
"""

from __future__ import annotations

import numpy as np

from velocity_tpu_torch.pipeline.roi import bounding_rect


def affine_from_feature_match(
    im1: np.ndarray,
    im2: np.ndarray,
    pts: np.ndarray,
    valid: np.ndarray | None = None,
    scale: float = 1.0,
    min_matches: int = 10,
    ratio: float = 0.6,
    detector: str = "SIFT",
):
    """Estimate the im1->im2 affine from ratio-tested feature matches.

    Args:
      im1, im2: uint8 grayscale frames.
      pts: (N, 2) last known point positions (defines the search ROI in im1).
      valid: optional (N,) mask for pts.
      scale: optional pre-downscale of both images for speed.
    Returns:
      (2, 3) float32 affine (full-resolution coordinates).
    """
    import cv2

    p1 = np.asarray(pts, np.float32)
    if valid is not None:
        p1 = p1[np.asarray(valid)]
    if scale != 1.0:
        im1 = cv2.resize(im1, (0, 0), fx=scale, fy=scale, interpolation=cv2.INTER_NEAREST)
        im2 = cv2.resize(im2, (0, 0), fx=scale, fy=scale, interpolation=cv2.INTER_NEAREST)

    if detector == "SIFT" and hasattr(cv2, "SIFT_create"):
        det = cv2.SIFT_create()
        norm = cv2.NORM_L2
    else:
        det = cv2.ORB_create(nfeatures=4000)
        norm = cv2.NORM_HAMMING
    bf = cv2.BFMatcher(norm)
    kp2, des2 = det.detectAndCompute(im2, mask=None)

    border = 0
    good, x0, y0 = [], 0, 0
    kp1 = []
    while len(good) < min_matches:
        b = int(border * scale)
        x0, x1, y0, y1 = bounding_rect(p1 * scale, im1.shape, border=(b, b))
        kp1, des1 = det.detectAndCompute(im1[y0:y1, x0:x1], mask=None)
        if des1 is not None and des2 is not None and len(kp1) >= 2:
            matches = bf.knnMatch(des1, des2, k=2)
            good = [m for m, n in matches if len([m, n]) == 2 and m.distance < ratio * n.distance]
        border += 10
        if border > 10 * 400:  # ROI has long covered the full frame
            break
    if len(good) < 3:
        return np.float32([[1, 0, 0], [0, 1, 0]])

    m1 = np.float32([kp1[m.queryIdx].pt for m in good]) + np.float32([x0, y0])
    m2 = np.float32([kp2[m.trainIdx].pt for m in good])
    M, _inl = cv2.estimateAffine2D(m1 / scale, m2 / scale, method=cv2.RANSAC)
    if M is None:
        return np.float32([[1, 0, 0], [0, 1, 0]])
    return M.astype(np.float32)
