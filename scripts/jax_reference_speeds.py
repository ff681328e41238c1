#!/usr/bin/env python3
"""Speeds the JAX package recovers on the port's synthetic clip, on the CPU.

    python3 scripts/jax_reference_speeds.py [scan_ba] [driver] [scan]

Renders the clip ``chip_smoke.py`` drives (seed 0, 1920x1080, 20 frames, 40
km/h) and runs the JAX package on it with the f32 solver and the default
widths: ``scan`` is ``ScanSpeedRunner`` (the ``"lanes"`` entry of
``JAX_CPU_SPEED_KMH`` in ``chip_smoke.py``), ``scan_ba`` the same with
``anchor="ba"`` (its ``"ba"`` entry), ``driver`` is ``SpeedEstimator.run``
(its ``"driver"`` entry). Prints one JSON line per run. This is the one
script outside the tests that imports both packages: the clip comes from the
port's fixture, the speeds from JAX. Minutes of CPU per run.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import velocity_tpu.ingest.native_loader as native_loader  # noqa: E402
import velocity_tpu.ingest.video as video  # noqa: E402
import velocity_tpu.pipeline.speedest as speedest  # noqa: E402
from velocity_tpu.camera.annotations import Annotation  # noqa: E402
from velocity_tpu.camera.database import camera_info  # noqa: E402
from velocity_tpu.config import PipelineConfig, SolverConfig  # noqa: E402
from velocity_tpu.pipeline.scan import ScanSpeedRunner  # noqa: E402
from velocity_tpu_torch.testing.synthetic_clip import render_clip  # noqa: E402

N_FRAMES, WIDTH, HEIGHT = 20, 1920, 1080


class _Reader:
    """The synthetic clip behind the JAX package's VideoReader interface."""

    def __init__(self, clip):
        info = camera_info("synthetic.MOV", "iPhone 6s", width=WIDTH, height=HEIGHT,
                           fps=30.0, frame_count=N_FRAMES)
        self.info = dataclasses.replace(
            info, focal_pix=np.asarray(clip.reader.info.focal_pix))
        self._clip = clip

    def frames(self, *args, **kwargs):
        return self._clip.reader.frames(*args, **kwargs)

    prefetch = frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def _no_native_loader(*args, **kwargs):
    raise OSError("frames come from the synthetic clip")


def main(which) -> int:
    clip = render_clip(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, seed=0)
    video.VideoReader = speedest.VideoReader = lambda *a, **k: _Reader(clip)
    native_loader.NativeVideoStream = _no_native_loader
    ann = Annotation(clip.annotation.q, clip.annotation.fname, clip.annotation.start_frame)
    solver = SolverConfig(dtype="float32")
    runs = {
        "scan": lambda: ScanSpeedRunner(PipelineConfig(solver=solver)),
        "scan_ba": lambda: ScanSpeedRunner(PipelineConfig(solver=solver, anchor="ba")),
        "driver": lambda: speedest.SpeedEstimator(PipelineConfig(solver=solver)),
    }
    for name in which or list(runs):
        res = runs[name]().run("synthetic.MOV", annotation=ann, n_frames=N_FRAMES,
                               verbose=False)
        print(json.dumps({"run": name, "speed_kmh": res.speed_kmh,
                          "speed_std": res.speed_std, "residual_px": res.residual_px,
                          "true_kmh": clip.speed_kmh, "platform": jax.default_backend()}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
