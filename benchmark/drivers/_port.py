"""What every driver hands the program: its configuration, the camera, the
plate annotation, and a rendered clip behind the interfaces of the program's
readers (``ingest.video.VideoReader``, ``ingest.stills.StillsReader``).

The readers stamp each pull with the host clock (``pulls``), which the
per-frame drivers' ``frame_gap_ms`` reads.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from velocity_tpu_torch.camera.annotations import Annotation
from velocity_tpu_torch.camera.database import camera_info
from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
from velocity_tpu_torch.ingest.video import Frame

_NESTED = {"solver": SolverConfig, "tracker": TrackerConfig}


def pipeline_config(config: dict) -> PipelineConfig:
    """The configuration's ``pipeline`` fields as a ``PipelineConfig``."""
    fields = {k: (_NESTED[k](**v) if k in _NESTED else v) for k, v in config["pipeline"].items()}
    return PipelineConfig(**fields)


def camera(config: dict, pcfg: PipelineConfig, n_frames: int):
    """The camera of a clip of ``n_frames`` frames, as the program's database
    gives it for the configuration's file name and size; its focal at
    ``native_scale`` has to be the scene's, which is checked."""
    sc = config["scene"]
    video = sc["stride"] == 1
    info = camera_info(config["filename"], config["platform"], width=sc["width"],
                       height=sc["height"], fps=sc["fps"] if video else 0.0,
                       frame_count=n_frames)
    # an image narrower than the native size at native_scale sees the same
    # view (a factor of 1 at the configurations' own sizes)
    native_w = (info.spec.video_size if info.is_video else info.spec.stills_size)[0]
    info = dataclasses.replace(
        info, focal_pix=info.focal_pix * (sc["width"] / (native_w * pcfg.native_scale)))
    f = float(info.focal_pix[0]) * pcfg.native_scale
    if abs(f - sc["focal_px"]) > 1e-6 * f or any(
            abs(a - b) > 1e-9 for a, b in zip(info.principal_point, sc["principal_point"])):
        raise ValueError(f"the scene's camera ({sc['focal_px']}, {sc['principal_point']}) is not "
                         f"the program's ({f}, {list(info.principal_point)})")
    return info


def annotation(config: dict, pcfg: PipelineConfig, corners_px: np.ndarray) -> Annotation:
    """The plate's corners in frame 0, in native pixels (image / native_scale)."""
    return Annotation(q=(corners_px / pcfg.native_scale).astype(np.float32),
                      fname=config["filename"], start_frame=0)


class ClipReader:
    """``VideoReader``'s interface over rendered uint8 frames."""

    def __init__(self, grays: np.ndarray, info, rate: float):
        self.grays = grays
        self.info = info
        self.rate = rate
        self.pulls: list[float] = []

    def frames(self, start: int = 0, count: int | None = None, step: int = 1):
        n = len(self.grays)
        i, k = start, 0
        while i < n and (count is None or k < count):
            self.pulls.append(time.perf_counter())
            yield Frame(index=i, time_s=i / self.rate, gray=self.grays[i])
            i += step
            k += 1

    def release(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class BurstReader:
    """``StillsReader``'s interface over rendered uint8 stills: ``.info``,
    ``.paths``, ``.frames()`` yielding (index, gray, [lat, lon, alt, s]),
    ``.yaw_deg(index)``."""

    def __init__(self, grays: np.ndarray, info, rate: float, gps_fix, yaw_deg: float):
        self.grays = grays
        self.info = dataclasses.replace(info, fps=0.0, frame_count=len(grays))
        self.rate = rate
        self.gps_fix = list(gps_fix)
        self._yaw = yaw_deg
        stem, ext = info.filename.rsplit(".", 1)
        self.paths = [f"{stem}_{i:04d}.{ext}" for i in range(len(grays))]
        self.pulls: list[float] = []

    def frames(self):
        for i, g in enumerate(self.grays):
            self.pulls.append(time.perf_counter())
            yield i, g, np.array([*self.gps_fix, i / self.rate])

    def yaw_deg(self, index: int = 0) -> float:
        return self._yaw


class VideoDriver:
    """A driver of a runner over a video reader: ``make_runner(pcfg,
    device)`` names the entry point; each call runs one clip with the mix's
    frame count and call arguments."""

    def __init__(self, config: dict, traffic: dict, device):
        self.config, self.traffic = config, traffic
        self.pcfg = pipeline_config(config)
        self.runner = self.make_runner(self.pcfg, device)

    def prepare(self, clip):
        sc = self.config["scene"]
        info = camera(self.config, self.pcfg, len(clip.grays))
        return (ClipReader(clip.grays, info, sc["fps"] / sc["stride"]),
                annotation(self.config, self.pcfg, clip.truth.corners_px))

    def __call__(self, item) -> dict:
        reader, ann = item
        res = self.runner.run(reader, annotation=ann, n_frames=self.traffic["frames"],
                              verbose=False, **self.traffic["call"])
        return answers(res)


def answers(res) -> dict:
    """What the reference judges of a ``RunResult``, as host numpy."""
    return {"B": np.asarray(res.B, np.float64), "S": np.asarray(res.S, np.float64),
            "track_px": np.asarray(res.track_px), "valid": np.asarray(res.valid),
            "timings": dict(res.timings)}
