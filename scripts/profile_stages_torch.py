#!/usr/bin/env python3
"""Per-stage times of one lanes frame step of the PyTorch/CUDA port on the
synthetic 1080p pair (twin of ``scripts/profile_stages_amortized.py``).

    python3 scripts/profile_stages_torch.py [--device cuda|cpu] [--lanes V]

Frame 0 and frame 1 of the seed-0 1920x1080 clip
(``velocity_tpu_torch/testing/synthetic_clip.py``), the default
configuration with the f32 solver; frame 0 initialised as the runners do.
With ``--lanes V`` (1 to 3), the step of ``run_batch``'s batched segment
over the first V clips of ``render_lanes`` (seeds 0/1/2 at 40/30/50
km/h, two frames each), one lane axis on every input. Each stage runs
from the same inputs:

- ``pyramids``: ``frame_pyramids`` of frame 1 (full and quarter scale);
- ``stages 1+2``: ``_track_stages_p``, the coarse LK, RANSAC, the
  full-resolution forward-backward LK and the stage-3 affine's RANSAC;
- ``stage 3``: ``_track_fine_p``, the affine-warped fine LK;
- ``pose LM``: ``estimate_world_camera_pose`` on stage 3's points;
- ``whole step``: ``fused_frame_step_pyr``, all of the above, eager (its
  loops stop early, with a host read per trip);
- ``captured step`` (CUDA only): the same step as ``scan_segment`` runs it
  on a card, one replay of its CUDA graph (``pipeline/scan.py``; its loops
  at their fixed trip count), the inputs and the frame's RANSAC noise
  copied in first; the capture is made before the timing.

For each: ``event ms``, CUDA events around ``REPS`` calls, per call, the
median of ``ROUNDS`` (stream time: the device's work and its idle gaps
while the host launches or reads back); ``wall ms``, the host's time per
call, the mean over the same rounds, each ending in a synchronisation
(``utils.profiling.StageTimer(sync=True)``); ``kernel ms`` and ``kernels``,
the device time and count of the kernels of one call under
``torch.profiler``; ``busy``, kernel ms over event ms. ``event ms`` near
``kernel ms`` means the stage keeps the device busy; far above it, the
host sets the pace. Prints one line per
stage, the card's name and power limit, and the table as JSON; on the CPU
(``--device cpu``) only ``wall ms`` is a number.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

REPS, ROUNDS = 10, 5


def _lane_inputs(dev, cfg, clip, seed):
    """One lane's tensors: frames 0 and 1, frame 0 initialised."""
    from velocity_tpu_torch.pipeline.roi import inside_bbox
    from velocity_tpu_torch.pipeline.speedest import _init_features, _init_geometry

    cam, scale = clip.reader.info, cfg.native_scale
    q = clip.annotation.q * scale
    im0, im1 = (torch.as_tensor(g).to(dev) for g in clip.reader.grays[:2])
    p, valid, boxa, _ = _init_features(cfg, im0, q)
    t0, p3, _ = _init_geometry(cfg, cam, q, p, valid, scale)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return dict(im0=im0, im1=im1, pts=torch.as_tensor(p, device=dev),
                vg=torch.as_tensor(valid, device=dev),
                vp=torch.as_tensor(valid & inside_bbox(p, boxa), device=dev),
                p3=torch.as_tensor(p3, dtype=torch.float32, device=dev),
                t0=torch.as_tensor(t0, dtype=torch.float32, device=dev),
                intr=cam.intrinsics(scale=scale).to(dtype=torch.float32, device=dev), gen=gen)


def _inputs(dev, lanes: int = 0):
    """The step's inputs for one clip (``lanes`` 0), or stacked over the
    first ``lanes`` clips of ``render_lanes``."""
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig
    from velocity_tpu_torch.geometry.projection import Intrinsics
    from velocity_tpu_torch.pipeline.tracker import frame_pyramids
    from velocity_tpu_torch.testing.synthetic_clip import BATCH_LANES, render_clip

    cfg = PipelineConfig(solver=SolverConfig(dtype="float32"))
    if not lanes:
        x = _lane_inputs(dev, cfg, render_clip(n_frames=2, seed=0), 1)
    else:
        xs = [_lane_inputs(dev, cfg, render_clip(n_frames=2, seed=seed, speed_kmh=kmh), v)
              for v, (seed, kmh) in enumerate(BATCH_LANES[:lanes])]
        x = {k: torch.stack([l[k] for l in xs]) for k in xs[0] if k not in ("intr", "gen")}
        x.update(intr=Intrinsics.stack([l["intr"] for l in xs]), gen=[l["gen"] for l in xs])
    x.update(zip(("pyr0", "spyr0"), frame_pyramids(x.pop("im0"), cfg.tracker)))
    x.update(zip(("pyr1", "spyr1"), frame_pyramids(x["im1"], cfg.tracker)))
    return dict(cfg=cfg, **x)


def _stages(x):
    """{name: zero-argument call} of the stages, on ``_inputs``' tensors."""
    from velocity_tpu_torch.pipeline.tracker import (
        _track_fine_p, _track_stages_p, frame_pyramids, fused_frame_step_pyr)
    from velocity_tpu_torch.solvers.pose import estimate_world_camera_pose

    cfg, tc = x["cfg"], x["cfg"].tracker
    T23, _ = _track_stages_p(x["pyr0"], x["pyr1"], x["spyr0"], x["spyr1"], x["pts"], x["vg"],
                             x["gen"], tc)
    p_new, vg_new = _track_fine_p(x["pyr0"], x["pyr1"], x["pts"], x["vg"], T23, tc)
    eye = torch.eye(3, dtype=torch.float32, device=x["im1"].device)
    stages = {
        "pyramids": lambda: frame_pyramids(x["im1"], tc),
        "stages 1+2": lambda: _track_stages_p(x["pyr0"], x["pyr1"], x["spyr0"], x["spyr1"],
                                              x["pts"], x["vg"], x["gen"], tc),
        "stage 3": lambda: _track_fine_p(x["pyr0"], x["pyr1"], x["pts"], x["vg"], T23, tc),
        "pose LM": lambda: estimate_world_camera_pose(
            x["intr"], p_new, x["p3"], t0=x["t0"], R0=eye, find_R=False,
            mask=x["vp"] & vg_new, config=cfg.solver),
        "whole step": lambda: fused_frame_step_pyr(
            x["pyr0"], x["spyr0"], x["im1"], x["pts"], x["vg"], x["vp"], x["p3"], x["intr"],
            x["gen"], tc, cfg.solver, torch.float32, x["t0"]),
    }
    if x["im1"].device.type == "cuda":
        from velocity_tpu_torch.pipeline.step_graph import _graph_step

        inputs = (x["im1"], (x["pyr0"], x["spyr0"], x["pts"], x["vg"], x["vp"], x["t0"]),
                  x["p3"], x["intr"])
        graph = _graph_step(*inputs, tc, cfg.solver, torch.float32, False)
        stages["captured step"] = lambda: graph(*inputs, x["gen"])
    return stages


def _kernel_time(fn):
    """(device ms, kernels) of one call of ``fn`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels)


def profile_stages(dev, lanes: int = 0) -> list:
    from velocity_tpu_torch.utils.profiling import StageTimer

    rows = []
    for name, fn in _stages(_inputs(dev, lanes)).items():
        fn()  # warm
        timer, events = StageTimer(), []
        for _ in range(ROUNDS):
            with timer.stage(name, sync=True):
                if dev.type == "cuda":
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                for _ in range(REPS):
                    fn()
                if dev.type == "cuda":
                    b.record()
            if dev.type == "cuda":
                events.append(a.elapsed_time(b) / REPS)
        row = {"stage": name, "wall_ms": 1e3 * timer.totals[name] / (ROUNDS * REPS),
               "event_ms": statistics.median(events) if events else None,
               "kernel_ms": None, "kernels": None}
        if dev.type == "cuda":
            row["kernel_ms"], row["kernels"] = _kernel_time(fn)
            row["busy"] = row["kernel_ms"] / row["event_ms"]
        rows.append(row)
        print(f"{name:13s} event {row['event_ms'] or float('nan'):9.3f} ms  wall "
              f"{row['wall_ms']:9.3f} ms  kernels {row['kernels']} in "
              f"{row['kernel_ms'] or float('nan'):8.3f} ms  busy "
              f"{row.get('busy', float('nan')):.1%}")
    return rows


def main(argv=None) -> int:
    from velocity_tpu_torch.pipeline.speedest import require_device
    from velocity_tpu_torch.utils.profiling import card_line

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--lanes", type=int, default=0,
                        help="profile the batched step of run_batch over this many clips")
    args = parser.parse_args(argv)
    dev = require_device(args.device, "profile_stages_torch")
    rows = profile_stages(dev, args.lanes)
    if dev.type == "cuda":
        print(card_line())
    print(json.dumps({"device": dev.type, "lanes": args.lanes, "reps": REPS, "rounds": ROUNDS,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
