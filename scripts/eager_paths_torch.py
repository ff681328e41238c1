#!/usr/bin/env python3
"""Times of the port's eager entry point and of its bench in both modes, to
hold one checkout of the package against another on the same card.

    python3 scripts/eager_paths_torch.py [--root DIR] [--label NAME] [--reps N]
                                         [--parts entry,frames,scan]

- ``entry``: ``graft_entry_torch.entry()``'s fused frame step (1024 points
  on a 512x1024 pair), called eagerly: ms per call between CUDA events,
  the median of ``--reps`` calls after one warm-up call, and the host's
  wall ms per call over the same calls, each ending in a synchronisation;
- ``bench frames`` and ``bench scan``: ``bench_torch.run_bench`` on the
  synthetic clip with the per-frame driver (``SpeedEstimator.run``) and
  with the scan runner (whose segments replay the captured frame step
  where the package has one): frames/s, the bench's median of its timed
  runs after its warm-up, and the speed found.

``--root DIR`` imports ``velocity_tpu_torch``, ``graft_entry_torch`` and
``bench_torch`` from another checkout, e.g. a parent commit unpacked with
``git archive`` into an ignored directory; run the two in turns, one after
another on one card (parent, change, change, parent). Prints the card's name
and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch


def _entry_ms(reps: int) -> dict:
    from graft_entry_torch import entry

    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    event, wall = [], []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        event.append(a.elapsed_time(b))
    return {"event_ms": statistics.median(event), "wall_ms": statistics.mean(wall)}


def _bench(mode: str) -> dict:
    import bench_torch

    video, annotation, start, reference = bench_torch.load_clip("synthetic")
    out, _ = bench_torch.run_bench(video, annotation, start_frame=start, mode=mode,
                                   reference_kmh=reference)
    return {"fps": out["value"], "walls_s": out["walls_s"], "speed_kmh": out["speed_kmh"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                        help="the checkout whose package is timed (default: this one)")
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--parts", default="entry,frames,scan",
                        help="what to time, of entry, frames and scan")
    args = parser.parse_args(argv)
    parts = args.parts.split(",")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import velocity_tpu_torch
    from velocity_tpu_torch.pipeline.speedest import require_device
    from velocity_tpu_torch.utils.profiling import card_line

    require_device("cuda", "eager_paths_torch")
    t0 = time.perf_counter()
    out = {"label": args.label, "package": str(Path(velocity_tpu_torch.__file__).parent)}
    if "entry" in parts:
        out["entry"] = _entry_ms(args.reps)
    for mode in ("frames", "scan"):
        if mode in parts:
            out[f"bench {mode}"] = _bench(mode)
    out["seconds"] = time.perf_counter() - t0
    print(f"{args.label}: " + ", ".join(
        f"entry {v['event_ms']:.3f} ms (wall {v['wall_ms']:.3f})" if k == "entry"
        else f"{k} {v['fps']:.3f} frames/s" for k, v in out.items() if isinstance(v, dict)))
    print(card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
