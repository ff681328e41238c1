#!/usr/bin/env python3
"""Speeds the JAX package recovers on the port's synthetic clip, on the CPU.

    python3 scripts/jax_reference_speeds.py [scan_ba] [driver] [scan] [stills] [batch]
                                            [batch_fast] [longvideo]

Renders the clip ``chip_smoke.py`` drives (seed 0, 1920x1080, 20 frames, 40
km/h) and runs the JAX package on it with the f32 solver and the default
widths: ``scan`` is ``ScanSpeedRunner`` (the ``"lanes"`` entry of
``JAX_CPU_SPEED_KMH`` in ``chip_smoke.py``), ``scan_ba`` the same with
``anchor="ba"`` (its ``"ba"`` entry), ``driver`` is ``SpeedEstimator.run``
(its ``"driver"`` entry). ``stills`` is ``StillsSpeedEstimator.run`` on the
smoke run's stills burst (``render_burst`` of
``velocity_tpu_torch/testing/synthetic_clip.py``; its ``"stills"`` entry)
and ``batch`` is ``run_batch`` over the smoke run's three clips
(``render_lanes``; its ``"batch"`` entry, one speed and residual per
lane), ``batch_fast`` the same with ``lk_backend="fast"`` (its
``"batch_fast"`` entry and ``JAX_CPU_BATCH_FAST_RESIDUAL_PX``). ``longvideo`` is ``LongVideoRunner.run`` (window 16, overlap 3, BA
refinement) on the first ``LONG_FRAMES`` frames of the same clip (its
``"longvideo"`` entry and ``JAX_CPU_LONGVIDEO_RESIDUAL_PX``).
Prints one JSON line per run. This is the one script outside the tests that
imports both packages: the scenes come from the port's fixture, the speeds
from JAX. Minutes of CPU per run; ``stills`` renders and tracks 12 MP frames
(about 3 GB of memory).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import velocity_tpu.ingest.native_loader as native_loader  # noqa: E402
import velocity_tpu.ingest.video as video  # noqa: E402
import velocity_tpu.pipeline.longvideo as longvideo  # noqa: E402
import velocity_tpu.pipeline.multivideo as multivideo  # noqa: E402
import velocity_tpu.pipeline.speedest as speedest  # noqa: E402
import velocity_tpu.pipeline.stills as stills  # noqa: E402
from velocity_tpu.camera.annotations import Annotation, save_annotation  # noqa: E402
from velocity_tpu.camera.database import camera_info  # noqa: E402
from velocity_tpu.config import PipelineConfig, SolverConfig, TrackerConfig  # noqa: E402
from velocity_tpu.pipeline.scan import ScanSpeedRunner  # noqa: E402
from velocity_tpu_torch.testing.synthetic_clip import (  # noqa: E402
    LONG_FRAMES, LONG_RUN, STILLS_BURST, render_burst, render_clip, render_lanes)

N_FRAMES, WIDTH, HEIGHT = 20, 1920, 1080


def _jax_camera(info):
    """A port CameraInfo as the JAX package's type."""
    jinfo = camera_info(info.filename, info.platform, width=info.width, height=info.height,
                        fps=info.fps, frame_count=info.frame_count)
    return dataclasses.replace(jinfo, focal_pix=np.asarray(info.focal_pix))


class _Reader:
    """A synthetic clip behind the JAX package's VideoReader interface."""

    def __init__(self, clip):
        self.info = _jax_camera(clip.reader.info)
        self._clip = clip

    def frames(self, *args, **kwargs):
        return self._clip.reader.frames(*args, **kwargs)

    prefetch = frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


class _StillsReader:
    """A synthetic stills burst behind the JAX package's StillsReader interface."""

    def __init__(self, burst):
        self.info = _jax_camera(burst.info)
        self.paths = burst.paths
        self.frames = burst.frames
        self.yaw_deg = burst.yaw_deg


def _no_native_loader(*args, **kwargs):
    raise OSError("frames come from the synthetic clip")


def _jax_annotation(clip):
    a = clip.annotation
    return Annotation(a.q, a.fname, a.start_frame)


def _result(name, res, true_kmh):
    return {"run": name, "speed_kmh": res.speed_kmh, "speed_std": res.speed_std,
            "residual_px": res.residual_px, "true_kmh": true_kmh,
            "platform": jax.default_backend()}


def _run_stills(solver):
    burst = render_burst()
    stills.StillsReader = lambda *a, **k: _StillsReader(burst.stills())
    cfg = PipelineConfig(native_scale=STILLS_BURST["native_scale"], solver=solver)
    res = stills.StillsSpeedEstimator(cfg).run(["synthetic.JPG"],
                                               annotation=_jax_annotation(burst),
                                               verbose=False)
    return [_result("stills", res, burst.speed_kmh)]


def _run_batch(solver, lk_backend="lanes"):
    lanes = render_lanes()
    paths = {f"lane{v}.MOV": c for v, c in enumerate(lanes)}
    multivideo.VideoReader = lambda path, *a, **k: _Reader(paths[path])
    with tempfile.TemporaryDirectory() as d:
        anns = [str(Path(d) / f"{p}.npz") for p in paths]
        for a, c in zip(anns, lanes):
            save_annotation(a, _jax_annotation(c))
        cfg = PipelineConfig(solver=solver, tracker=TrackerConfig(lk_backend=lk_backend))
        res = multivideo.run_batch(list(paths), annotations=anns, n_frames=N_FRAMES,
                                   config=cfg, verbose=False)
    name = "batch" if lk_backend == "lanes" else f"batch_{lk_backend}"
    return [dict(_result(name, r, c.speed_kmh), lane=v)
            for v, (r, c) in enumerate(zip(res, lanes))]


def _run_longvideo(solver):
    clip = render_clip(n_frames=LONG_FRAMES, width=WIDTH, height=HEIGHT, seed=0)
    video.VideoReader = lambda *a, **k: _Reader(clip)
    res = longvideo.LongVideoRunner(PipelineConfig(solver=solver)).run(
        "synthetic.MOV", annotation=_jax_annotation(clip), verbose=False, **LONG_RUN)
    return [dict(_result("longvideo", res, clip.speed_kmh), frames=LONG_FRAMES, **LONG_RUN)]


def main(which) -> int:
    native_loader.NativeVideoStream = _no_native_loader
    solver = SolverConfig(dtype="float32")
    on_clip = {
        "scan": lambda: ScanSpeedRunner(PipelineConfig(solver=solver)),
        "scan_ba": lambda: ScanSpeedRunner(PipelineConfig(solver=solver, anchor="ba")),
        "driver": lambda: speedest.SpeedEstimator(PipelineConfig(solver=solver)),
    }
    clip = None
    for name in which or [*on_clip, "stills", "batch", "batch_fast", "longvideo"]:
        if name == "stills":
            lines = _run_stills(solver)
        elif name == "batch":
            lines = _run_batch(solver)
        elif name == "batch_fast":
            lines = _run_batch(solver, "fast")
        elif name == "longvideo":
            lines = _run_longvideo(solver)
        else:
            if clip is None:
                clip = render_clip(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, seed=0)
            video.VideoReader = speedest.VideoReader = lambda *a, **k: _Reader(clip)
            res = on_clip[name]().run("synthetic.MOV", annotation=_jax_annotation(clip),
                                      n_frames=N_FRAMES, verbose=False)
            lines = [_result(name, res, clip.speed_kmh)]
        for line in lines:
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
