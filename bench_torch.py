"""Benchmark of the PyTorch/CUDA port: frames/s of one clip end to end,
decode included. Twin of ``bench.py``.

    python3 bench_torch.py [--clip synthetic|IMG_4119] [--mode scan|frames] [--device cuda|cpu]
    python -m velocity_tpu_torch bench [the same flags]

The protocol of ``bench.py``: the default pipeline with the f32 solver,
``N_FRAMES`` frames, one warm-up run at the timed shape, then ``REPS`` timed
runs with ``lean=True`` (after the MSV frame one packed summary per frame
comes back to the host, not the per-point history); frames/s from the
median wall. Prints one JSON line: ``metric`` (naming the clip), ``value``,
``unit``, ``mode``, ``speed_kmh``, ``speed_std``, ``reference_speed_kmh``,
``speed_err_kmh``, ``residual_px``, the frames and every timed wall, and
``device``: on CUDA the card's name and power limit as ``nvidia-smi``
reports them.

Clips (``--clip``): ``synthetic`` is the seeded 1920x1080 clip of
``velocity_tpu_torch/testing/synthetic_clip.py`` (seed 0, 20 frames), the
one ``chip_smoke.py`` drives, held to its true speed; ``IMG_4119`` is the
reference clip (``pipeline/datasets.py:known_run``) held to its golden
18.74 km/h, and raises where the video is absent. ``vs_baseline``, the
ratio to the reference CPU implementation's 14.67 frames/s on IMG_4119
(``BASELINE.md``), is printed for IMG_4119 only.

``--mode scan`` times ``ScanSpeedRunner.run``, ``--mode frames``
``SpeedEstimator.run``. Unlike ``bench.py`` a failing run is not caught and
no other mode is tried: the command exits non-zero. ``--device`` defaults to
"cuda" and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

BASELINE_FPS_4119 = 14.67
GOLDEN_SPEED_4119 = 18.74
N_FRAMES = 20
REPS = 5


def bench_config():
    """The timed configuration: the default pipeline, f32 solver."""
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig

    return PipelineConfig(solver=SolverConfig(dtype="float32"))


def load_clip(name: str, n_frames: int = N_FRAMES):
    """(video path or reader, annotation, start frame or None, reference speed
    km/h) of clip ``name``."""
    if name == "synthetic":
        from velocity_tpu_torch.testing.synthetic_clip import render_clip

        clip = render_clip(n_frames=n_frames, seed=0)
        return clip.reader, clip.annotation, None, clip.speed_kmh
    if name == "IMG_4119":
        from velocity_tpu_torch.pipeline.datasets import known_run

        run = known_run(name)
        if not Path(run.video).exists():
            raise FileNotFoundError(f"{run.video}: the IMG_4119 video is not on this machine")
        return run.video, run.annotation, run.start_frame, GOLDEN_SPEED_4119
    raise ValueError(f"unknown clip {name!r}")


def device_fields(dev) -> dict:
    if dev.type != "cuda":
        return {"type": dev.type}
    from velocity_tpu_torch.utils.profiling import card

    return {"type": "cuda", **card()}


def run_bench(reader_or_path, annotation, *, start_frame=None, n_frames=N_FRAMES, reps=REPS,
              mode="scan", device="cuda", clip="synthetic", reference_kmh=None):
    """Warm up, then time ``reps`` lean runs of ``mode`` ("scan" or
    "frames") over the clip on ``device``. Returns (the JSON object the
    bench prints, the last timed run's ``RunResult``)."""
    import torch

    from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner
    from velocity_tpu_torch.pipeline.speedest import SpeedEstimator, require_device

    dev = require_device(device, "bench")
    cfg = bench_config()
    if mode == "scan":
        runner, extra = ScanSpeedRunner(cfg, device=dev), {}
    elif mode == "frames":
        runner, extra = SpeedEstimator(cfg, device=dev), {"collect_images": False}
    else:
        raise ValueError(f"unknown mode {mode!r}")

    def run():
        res = runner.run(reader_or_path, annotation=annotation, start_frame=start_frame,
                         n_frames=n_frames, verbose=False, lean=True, **extra)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res

    run()  # warm-up at the timed shape
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
    n = res.S.shape[0]
    fps = n / statistics.median(walls)
    out = {"metric": f"frames/s/chip {clip} end-to-end (incl. decode)", "value": fps,
           "unit": "fps", "mode": mode, "frames": n, "speed_kmh": res.speed_kmh,
           "speed_std": res.speed_std, "residual_px": res.residual_px, "walls_s": walls}
    if reference_kmh is not None:
        out["reference_speed_kmh"] = reference_kmh
        out["speed_err_kmh"] = abs(res.speed_kmh - reference_kmh)
    if clip == "IMG_4119":
        out["vs_baseline"] = fps / BASELINE_FPS_4119
    out["device"] = device_fields(dev)
    return out, res


def main(argv=None) -> int:
    from velocity_tpu_torch.cli import add_bench_args
    from velocity_tpu_torch.pipeline.speedest import require_device

    parser = argparse.ArgumentParser(prog="bench_torch", description=__doc__.splitlines()[0])
    add_bench_args(parser)
    args = parser.parse_args(argv)
    require_device(args.device, "bench")
    video, annotation, start, reference = load_clip(args.clip)
    out, _res = run_bench(video, annotation, start_frame=start, n_frames=N_FRAMES, reps=REPS,
                          mode=args.mode, device=args.device, clip=args.clip,
                          reference_kmh=reference)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
