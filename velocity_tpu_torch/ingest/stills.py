"""Stills ingest: grayscale load + EXIF LLAT per image.

Parity: the reference's stills branch (vidExample.py:92-95, images.py:125-137).
A copy of ``velocity_tpu/ingest/stills.py``; cv2 is imported inside the call.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from velocity_tpu_torch.camera.database import CameraInfo, camera_info
from velocity_tpu_torch.camera.exif import exif_image_size, exif_to_llat, exif_yaw_deg, read_exif


def load_still(path: str | Path, grayscale: bool = True) -> np.ndarray:
    import cv2

    flag = 0 if grayscale else 1
    im = cv2.imread(str(path), flag)
    if im is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return im


class StillsReader:
    """Sequential reader over an ordered list of still images."""

    def __init__(self, paths: list[str | Path], platform: str = "iPhone 6s"):
        if not paths:
            raise ValueError("empty stills list")
        self.paths = [str(p) for p in paths]
        exif = read_exif(self.paths[0])
        try:
            w, h = exif_image_size(exif)
        except KeyError:
            im0 = load_still(self.paths[0])
            h, w = im0.shape[:2]
        self.info: CameraInfo = camera_info(
            self.paths[0],
            platform,
            width=w,
            height=h,
            fps=0.0,
            frame_count=len(self.paths),
            orientation=int(exif.get("Orientation", 1) or 1),
        )

    def frames(self) -> Iterator[tuple[int, np.ndarray, np.ndarray | None]]:
        """Yield (index, grayscale image, llat-or-None) per still."""
        for i, p in enumerate(self.paths):
            gray = load_still(p)
            exif = read_exif(p)
            try:
                llat = exif_to_llat(exif)
            except KeyError:
                llat = None
            yield i, gray, llat

    def yaw_deg(self, index: int = 0) -> float | None:
        """True-north camera yaw of one still (GPSImgDirection + declination,
        matlab/runExample.m:49-50)."""
        return exif_yaw_deg(read_exif(self.paths[index]))
