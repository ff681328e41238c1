"""A seeded synthetic car-rear clip at the real clips' size (numpy only).

A planar car rear carrying a Chile license plate recedes from the camera at
a known speed while drifting sideways, over a smooth low-contrast static
background. By default it is seen through the iPhone 6s video intrinsics at
``native_scale=0.5`` (the geometry of the reference's 1920x1080 clips), so
the plate-anchored pipeline can recover the speed. The reader has the
interface of ``ingest.video.VideoReader`` that the runner uses (``.info``,
``.frames``, context manager); frames are rendered once when the clip is
built.

A stills burst is the same scene rendered at every ``stride``-th instant
through the stills camera (a ``.JPG`` file name selects the stills focal,
3486 px at 4032 wide, at ``native_scale=1.0``); ``SyntheticClip.stills()``
puts it behind the interface of ``ingest.stills.StillsReader`` with a GPS
fix and a capture time per still.

``render_burst`` and ``render_lanes`` are the full-size scenes of
``chip_smoke.py``'s phases ``stills`` and ``multivideo``, and
``LONG_FRAMES`` / ``LONG_RUN`` its phase ``longvideo``, which
``scripts/jax_reference_speeds.py`` runs through the JAX package.

The pipeline's model holds exactly here: every textured point lies on the
plate plane, the camera is static and the car does not rotate, so a tracker
and solver that work recover ``speed_kmh`` up to tracking noise.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from velocity_tpu_torch.camera.annotations import Annotation
from velocity_tpu_torch.camera.database import CameraInfo, camera_info
from velocity_tpu_torch.geometry.plate import license_plate_points
from velocity_tpu_torch.ingest.video import Frame

FPS = 30.0
NATIVE_SCALE = 0.5  # PipelineConfig.native_scale: 4K annotations, 2K video
# car-rear extent in the plate frame (m): x right, y down, plate at the origin
CAR_X = (-0.85, 0.85)
CAR_Y = (-0.75, 0.35)
TEXEL_M = 0.004  # car texture resolution
SPEED_KMH = 40.0  # of the car relative to the camera
DEPTH0_M = 3.0  # plate depth at frame 0 (the annotated real clip's plate is ~4 m away)
NOISE = 1.0  # sensor noise, gray levels (std)
GPS_FIX = (-33.45, -70.66, 520.0)  # the stills' camera fix: lat, lon (deg), alt (m)
YAW_DEG = 32.56  # the stills' true-north camera heading (deg)
# the full-size stills burst of render_burst (the real burst IMG_4122-4133 is
# 12 stills of 4032x3024), seen through the stills focal at native_scale 1
STILLS_N, STILLS_SIZE = 12, (4032, 3024)
STILLS_BURST = dict(speed_kmh=40.0, depth0_m=4.0, fps=30.0, stride=3, filename="synthetic.JPG",
                    native_scale=1.0)
# (seed, speed km/h) of each 1080p clip of render_lanes
BATCH_LANES = ((0, 40.0), (1, 30.0), (2, 50.0))
LANE_FRAMES = 20
# the long-video run: the seed-0 1080p clip rendered to LONG_FRAMES frames
# (its first 20 are the clip above), through LongVideoRunner.run(**LONG_RUN)
LONG_FRAMES = 48
LONG_RUN = dict(window=16, overlap=3, ba_refine=True)


class SyntheticVideoReader:
    """``VideoReader``-compatible reader over pre-rendered uint8 frames."""

    def __init__(self, grays: np.ndarray, info: CameraInfo, fps: float = FPS):
        """``fps``: the rate of the rendered frames (frame i is at i / fps)."""
        self.grays = grays
        self.info = info
        self.fps = fps

    def frames(self, start: int = 0, count: int | None = None, step: int = 1):
        n = len(self.grays)
        i = start
        k = 0
        while i < n and (count is None or k < count):
            yield Frame(index=i, time_s=i / self.fps, gray=self.grays[i].copy())
            i += step
            k += 1

    def release(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class SyntheticStillsReader:
    """``StillsReader``-compatible reader over pre-rendered uint8 stills:
    ``.info``, ``.paths``, ``.frames()`` yielding (index, gray, llat) with
    llat = [lat, lon, alt, seconds], ``.yaw_deg(index)``."""

    def __init__(self, grays: np.ndarray, info: CameraInfo, fps: float):
        """Still i was taken at i / ``fps`` seconds, from ``GPS_FIX``."""
        self.grays = grays
        self.info = info
        self.fps = fps
        stem, ext = Path(info.filename).stem, info.extension
        self.paths = [f"{stem}_{i:04d}{ext}" for i in range(len(grays))]

    def frames(self):
        for i, g in enumerate(self.grays):
            yield i, g.copy(), np.array([*GPS_FIX, i / self.fps])

    def yaw_deg(self, index: int = 0) -> float | None:
        return YAW_DEG


@dataclass
class SyntheticClip:
    reader: SyntheticVideoReader
    annotation: Annotation  # q in native pixel coordinates (image / native_scale)
    speed_kmh: float  # true speed of the car relative to the camera
    plane_to_image: np.ndarray  # (n_frames, 3, 3) homographies, plate plane (m) -> pixels

    def stills(self) -> SyntheticStillsReader:
        """The clip's frames as a stills burst, one capture time per frame."""
        r = self.reader
        info = dataclasses.replace(r.info, fps=0.0, frame_count=len(r.grays))
        return SyntheticStillsReader(r.grays, info, r.fps)

    def motion_affine(self, i_prev: int, i_cur: int) -> np.ndarray:
        """The (2, 3) float32 affine that best maps the car rear's pixels in
        frame ``i_prev`` to frame ``i_cur`` (least squares over a grid of
        the car's plane): what a feature match of the two frames estimates."""
        X, Y = np.meshgrid(np.linspace(*CAR_X, 9), np.linspace(*CAR_Y, 7))
        plane = np.stack([X.ravel(), Y.ravel(), np.ones(X.size)], axis=1)

        def pixels(i):
            ph = plane @ self.plane_to_image[i].T
            return ph[:, :2] / ph[:, 2:]

        src = np.concatenate([pixels(i_prev), np.ones((len(plane), 1))], axis=1)
        M, *_ = np.linalg.lstsq(src, pixels(i_cur), rcond=None)
        return M.T.astype(np.float32)

    def frame_index(self, gray: np.ndarray) -> int:
        """Which frame of the clip ``gray`` is (frames differ by their noise)."""
        for i, g in enumerate(self.reader.grays):
            if np.array_equal(g, gray):
                return i
        raise ValueError("not a frame of this clip")


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur, edge-replicated borders."""
    r = max(1, int(round(3 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    out = img.astype(np.float64)
    for axis in (0, 1):
        p = np.pad(out, [(r, r) if a == axis else (0, 0) for a in (0, 1)], mode="edge")
        n = out.shape[axis]
        acc = np.zeros_like(out)
        for i, w in enumerate(k):
            acc += w * (p[i:i + n] if axis == 0 else p[:, i:i + n])
        out = acc
    return out


def _car_texture(rng: np.random.Generator) -> np.ndarray:
    """(rows, cols) texture over CAR_X x CAR_Y at TEXEL_M: blocky paint and
    parts with sharp-ish corners, plus the plate with dark characters."""
    W = int(round((CAR_X[1] - CAR_X[0]) / TEXEL_M))
    H = int(round((CAR_Y[1] - CAR_Y[0]) / TEXEL_M))
    tex = np.full((H, W), 105.0)
    for _ in range(420):
        w = int(rng.integers(5, 26))
        h = int(rng.integers(5, 26))
        x0 = int(rng.integers(0, W - w))
        y0 = int(rng.integers(0, H - h))
        tex[y0:y0 + h, x0:x0 + w] = rng.uniform(25, 215)

    def px(x, y):  # plate-frame metres -> texel index
        return int(round((x - CAR_X[0]) / TEXEL_M)), int(round((y - CAR_Y[0]) / TEXEL_M))

    pw, ph = 0.3725, 0.1275
    m = 0.012
    x0, y0 = px(-pw / 2 - m, -ph / 2 - m)
    x1, y1 = px(pw / 2 + m, ph / 2 + m)
    tex[y0:y1, x0:x1] = 35.0  # dark plate holder
    x0, y0 = px(-pw / 2, -ph / 2)
    x1, y1 = px(pw / 2, ph / 2)
    tex[y0:y1, x0:x1] = 235.0  # plate
    for c in range(6):  # characters: dark blocks with light holes
        cx0 = -pw / 2 + 0.02 + c * 0.056
        a0, b0 = px(cx0, -0.045)
        a1, b1 = px(cx0 + 0.040, 0.045)
        tex[b0:b1, a0:a1] = 30.0
        ha = int(rng.integers(a0 + 2, a1 - 4))
        hb = int(rng.integers(b0 + 2, b1 - 6))
        tex[hb:hb + int(rng.integers(3, 6)), ha:ha + 3] = 235.0
    return _blur(tex, 0.8)


def _background(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """Smooth, low-contrast static scene: upsampled coarse noise + gradient."""
    coarse = rng.uniform(-1.0, 1.0, (5, 8))
    yy = np.linspace(0, coarse.shape[0] - 1, height)
    xx = np.linspace(0, coarse.shape[1] - 1, width)
    y0 = np.floor(yy).astype(int).clip(0, coarse.shape[0] - 2)
    x0 = np.floor(xx).astype(int).clip(0, coarse.shape[1] - 2)
    fy = (yy - y0)[:, None]
    fx = (xx - x0)[None, :]
    c = coarse
    smooth = ((1 - fy) * ((1 - fx) * c[y0][:, x0] + fx * c[y0][:, x0 + 1])
              + fy * ((1 - fx) * c[y0 + 1][:, x0] + fx * c[y0 + 1][:, x0 + 1]))
    grad = np.linspace(-1.0, 1.0, height)[:, None]
    return 120.0 + 12.0 * smooth + 8.0 * grad


def _sample(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear texture lookup at fractional texel coordinates (clamped)."""
    H, W = tex.shape
    u = np.clip(u, 0, W - 1.001)
    v = np.clip(v, 0, H - 1.001)
    x0 = np.floor(u).astype(np.int64)
    y0 = np.floor(v).astype(np.int64)
    fx = u - x0
    fy = v - y0
    return ((1 - fy) * ((1 - fx) * tex[y0, x0] + fx * tex[y0, x0 + 1])
            + fy * ((1 - fx) * tex[y0 + 1, x0] + fx * tex[y0 + 1, x0 + 1]))


def _rotation(yaw: float, pitch: float) -> np.ndarray:
    """Row-vector plate rotation: rows are the plate axes in camera coordinates."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return Rx @ Ry


def render_clip(n_frames: int = 20, width: int = 1920, height: int = 1080,
                seed: int = 0, *, speed_kmh: float = SPEED_KMH, depth0_m: float = DEPTH0_M,
                fps: float = FPS, stride: int = 1, filename: str = "synthetic.MOV",
                native_scale: float = NATIVE_SCALE) -> SyntheticClip:
    """Render the clip; ``width``/``height`` scale the whole view (the
    focal length scales with the width, so a small clip shows the same
    scene at lower resolution). Frame i shows the instant ``i * stride /
    fps``. ``filename``'s extension picks the camera's video or stills
    focal, seen at ``native_scale`` (``PipelineConfig.native_scale``)."""
    rng = np.random.default_rng(seed)
    info = camera_info(filename, "iPhone 6s", width=width, height=height,
                       fps=fps, frame_count=n_frames)
    # the iPhone 6s focal at the native width times native_scale (1920 px
    # for video); narrower images see the same view
    native_w = (info.spec.video_size if info.is_video else info.spec.stills_size)[0]
    info = dataclasses.replace(info, focal_pix=info.focal_pix * (width / (native_w * native_scale)))
    f = float(info.focal_pix[0]) * native_scale
    cx, cy = (float(v) for v in info.principal_point)
    K = np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]])

    R = _rotation(np.radians(12.0), np.radians(-6.0))
    # the car drives down the lane beside the camera's line of sight (off
    # axis, as in the reference clips), so the MSV rays have parallax
    t0 = np.array([0.6, 0.45, depth0_m])
    direction = np.array([0.05, 0.0, 1.0])
    v = direction / np.linalg.norm(direction) * (speed_kmh / 3.6)
    rate = fps / stride  # rendered frames per second
    t_cam = t0[None, :] + v[None, :] * (np.arange(n_frames)[:, None] / rate)

    tex = _car_texture(rng)
    bg = _background(rng, height, width)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1)  # (H, W, 3)

    grays = np.empty((n_frames, height, width), np.uint8)
    # plane point (X, Y, 0) -> camera X*R[0] + Y*R[1] + t -> pixel via K
    plane_to_image = np.stack([K @ np.stack([R[0], R[1], t_cam[i]], axis=1)
                               for i in range(n_frames)])
    for i in range(n_frames):
        q = pix @ np.linalg.inv(plane_to_image[i]).T
        X = q[..., 0] / q[..., 2]
        Y = q[..., 1] / q[..., 2]
        car = _sample(tex, (X - CAR_X[0]) / TEXEL_M, (Y - CAR_Y[0]) / TEXEL_M)
        # soft silhouette: coverage from the distance to the car's edge, in
        # pixels (one pixel spans ~depth/f metres on the plane)
        inside = np.minimum.reduce([X - CAR_X[0], CAR_X[1] - X, Y - CAR_Y[0], CAR_Y[1] - Y])
        alpha = np.clip(inside / (t_cam[i, 2] / f) + 0.5, 0.0, 1.0)
        img = alpha * car + (1.0 - alpha) * bg
        img = img + rng.normal(0.0, NOISE, img.shape)
        grays[i] = np.clip(np.round(img), 0, 255).astype(np.uint8)

    plate = license_plate_points("Chile", np.float64)
    pc = plate @ R + t_cam[0]
    q_img = (pc @ K.T)[:, :2] / pc[:, 2:3]
    ann = Annotation(q=(q_img / native_scale).astype(np.float32), fname=filename,
                     start_frame=0)
    dv = np.diff(t_cam, axis=0)
    speed = float(np.linalg.norm(dv, axis=1).mean() * rate * 3.6)
    return SyntheticClip(reader=SyntheticVideoReader(grays, info, rate), annotation=ann,
                         speed_kmh=speed, plane_to_image=plane_to_image)


def render_burst() -> SyntheticClip:
    """The full-size stills burst (``STILLS_N`` stills of ``STILLS_SIZE``,
    ``STILLS_BURST``); its stills are ``.stills()``."""
    w, h = STILLS_SIZE
    return render_clip(n_frames=STILLS_N, width=w, height=h, seed=0, **STILLS_BURST)


def render_lanes(lane0: SyntheticClip | None = None) -> list[SyntheticClip]:
    """The 1920x1080 clips of ``LANE_FRAMES`` frames, one per ``BATCH_LANES``
    entry; ``lane0``, where given, is the first, already rendered."""
    return [lane0 if v == 0 and lane0 is not None else
            render_clip(n_frames=LANE_FRAMES, width=1920, height=1080, seed=seed, speed_kmh=kmh)
            for v, (seed, kmh) in enumerate(BATCH_LANES)]
