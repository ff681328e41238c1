"""Camera intrinsics database and per-file camera info.

Parity: reference ``getCameraParams`` (reference utils/images.py:93-181).
The iPhone 6s constants (sensor 4.80x3.60 mm, f=4.15 mm, stills focal 3486 px,
video focal 3486 * diag(4032,3024)/diag(3840,2160)) are reproduced exactly,
including the principal point convention ``(w, h)/2 + 0.5`` and the video focal
diagonal-ratio rule. Video stream probing is delegated to the ingest layer so
this module stays free of cv2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np

from velocity_tpu_torch.geometry.projection import Intrinsics


@dataclass(frozen=True)
class PlatformSpec:
    """Static per-device optics constants."""

    sensor_size_mm: tuple[float, float]
    focal_length_mm: float
    stills_focal_pix: float
    stills_size: tuple[int, int]  # (width, height)
    video_size: tuple[int, int]  # native video capture size (width, height)
    stills_klt_block: tuple[int, int] = (21, 21)
    video_klt_block: tuple[int, int] = (51, 51)

    @property
    def video_focal_pix(self) -> float:
        """Video focal from the stills focal via the diagonal-length ratio.

        iPhones crop the sensor for video; the reference derives the video focal
        as ``3486 * diag(stills)/diag(video)`` (utils/images.py:118-122).
        """
        sw, sh = self.stills_size
        vw, vh = self.video_size
        return self.stills_focal_pix * math.hypot(sw, sh) / math.hypot(vw, vh)

    @property
    def fov_deg(self) -> tuple[float, float]:
        w, h = self.sensor_size_mm
        f = self.focal_length_mm
        return (
            math.degrees(2 * math.atan(w / 2 / f)),
            math.degrees(2 * math.atan(h / 2 / f)),
        )


PLATFORM_DB: dict[str, PlatformSpec] = {
    "iPhone 6s": PlatformSpec(
        sensor_size_mm=(4.80, 3.60),
        focal_length_mm=4.15,
        stills_focal_pix=3486.0,
        stills_size=(4032, 3024),
        video_size=(3840, 2160),
    ),
}

VIDEO_EXTENSIONS = {".mov", ".m4v", ".mp4"}


@dataclass
class CameraInfo:
    """Resolved camera parameters for one media file."""

    fullfilename: str
    filename: str  # stem + extension, e.g. "IMG_4134.MOV"
    extension: str
    is_video: bool
    width: float
    height: float
    fps: float
    frame_count: float
    platform: str
    focal_pix: np.ndarray  # (2,) [fx, fy]
    principal_point: np.ndarray  # (2,) [cx, cy]
    skew: float = 0.0
    radial_distortion: tuple[float, float, float] = (0.0, 0.0, 0.0)
    orientation: int = 1  # 1 = landscape, 6 = portrait
    klt_block: tuple[int, int] = (51, 51)
    spec: PlatformSpec | None = field(default=None, repr=False)

    @property
    def intrinsic_matrix_rowvec(self) -> np.ndarray:
        """Row-vector K layout (reference utils/images.py:148-151)."""
        fx, fy = self.focal_pix
        cx, cy = self.principal_point
        return np.array(
            [[fx, 0, 0], [self.skew, fy, 0], [cx, cy, 1]], dtype=np.float32
        )

    def intrinsics(self, scale: float = 1.0) -> Intrinsics:
        """As an ``Intrinsics`` tuple of f32 CPU scalars, with optional focal rescale.

        ``scale`` implements the 4K->2K rule: it scales the focal lengths and
        skew but not the principal point (reference vidExample.py:35-39).
        """
        import torch

        fx, fy = self.focal_pix
        cx, cy = self.principal_point
        f32 = torch.float32
        return Intrinsics(
            fx=torch.tensor(fx * scale, dtype=f32),
            fy=torch.tensor(fy * scale, dtype=f32),
            cx=torch.tensor(cx, dtype=f32),
            cy=torch.tensor(cy, dtype=f32),
            skew=torch.tensor(self.skew * scale, dtype=f32),
        )

    def scaled(self, factor: float) -> "CameraInfo":
        """CameraInfo with focal scaled by ``factor`` (principal point kept)."""
        return replace(self, focal_pix=self.focal_pix * factor)


def camera_info(
    path: str | Path,
    platform: str = "iPhone 6s",
    *,
    width: float | None = None,
    height: float | None = None,
    fps: float = 0.0,
    frame_count: float = 1.0,
    orientation: int | None = None,
) -> CameraInfo:
    """Build a ``CameraInfo`` for a media file.

    For videos the caller should pass probed ``width``/``height``/``fps``/
    ``frame_count`` (see ``velocity_tpu_torch.ingest.video.VideoReader`` which wires
    this automatically); for stills they come from EXIF via the stills loader.
    """
    path = Path(path)
    if platform not in PLATFORM_DB:
        raise ValueError(
            f"unknown camera platform {platform!r}; known: {sorted(PLATFORM_DB)}"
        )
    spec = PLATFORM_DB[platform]
    ext = path.suffix
    is_video = ext.lower() in VIDEO_EXTENSIONS

    if is_video:
        w = float(width if width is not None else spec.video_size[0])
        h = float(height if height is not None else spec.video_size[1])
        focal = spec.video_focal_pix
        klt_block = spec.video_klt_block
    else:
        w = float(width if width is not None else spec.stills_size[0])
        h = float(height if height is not None else spec.stills_size[1])
        focal = spec.stills_focal_pix
        klt_block = spec.stills_klt_block

    if orientation is None:
        orientation = 1 if w > h else 6

    return CameraInfo(
        fullfilename=str(path),
        filename=path.name,
        extension=ext,
        is_video=is_video,
        width=w,
        height=h,
        fps=fps,
        frame_count=frame_count,
        platform=platform,
        focal_pix=np.array([focal, focal], dtype=np.float64),
        principal_point=np.array([w, h], dtype=np.float64) / 2 + 0.5,
        orientation=orientation,
        klt_block=klt_block,
        spec=spec,
    )
