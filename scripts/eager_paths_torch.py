#!/usr/bin/env python3
"""Times of the port's per-frame paths in two checkouts of the package, in
turns on one card, to hold a parent commit against a change.

    python3 scripts/eager_paths_torch.py [--parent DIR] [--pairs N]
                                         [--parts frames,cli,stills,scan,entry]

One worker process per checkout (this one, and ``--parent DIR``, e.g. the
parent commit unpacked with ``git archive`` into an ignored directory)
imports that checkout's ``velocity_tpu_torch``, ``bench_torch`` and
``graft_entry_torch``, renders what its parts need once and warms each part
up once; then the two take ``--pairs`` pairs of turns, parent first in even
pairs and change first in odd ones, one measurement of every part a turn:

- ``frames``: ``bench_torch.run_bench`` in ``--mode frames`` (the per-frame
  driver, lean) on the synthetic 1080p clip, one timed run after its
  warm-up: frames/s;
- ``cli``: the command line's ``speed`` (``build_parser``, ``cmd_speed``,
  ``--json --quiet``) on the same clip's reader: wall seconds;
- ``stills``: ``StillsSpeedEstimator.run`` on the full-size burst of 12
  stills of 4032x3024 (``render_burst``): wall seconds; the first run of
  the process (its warm-up, with any capture) is kept as ``cold_s``;
- ``scan``: ``run_bench`` in ``--mode scan``: frames/s;
- ``entry``: ``graft_entry_torch.entry()``'s frame step called eagerly: ms
  between CUDA events, the median of 20 calls.

Prints, for every part and checkout, the median and the quartiles over the
turns and in how many pairs the change was faster, then the card's name and
power limit, then one JSON line with every value.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
CLI_ARGV = ["speed", "--video", "clip.MOV", "--frames", "20", "--json", "--quiet"]
HIGHER_IS_FASTER = {"frames": True, "scan": True, "cli": False, "stills": False,
                    "entry": False}


class Worker:
    """The measurements of one checkout, in this process."""

    def __init__(self):
        import torch

        from velocity_tpu_torch.pipeline.speedest import require_device

        require_device("cuda", "eager_paths_torch")
        self.torch = torch
        self._clip = self._burst = self._stills_est = None
        self.cold_s = None

    def clip(self):
        if self._clip is None:
            import bench_torch

            self._clip = bench_torch.load_clip("synthetic")
        return self._clip

    def frames(self, mode="frames"):
        import bench_torch

        video, annotation, start, reference = self.clip()
        out, _ = bench_torch.run_bench(video, annotation, start_frame=start, reps=1, mode=mode,
                                       reference_kmh=reference)
        return out["value"]

    def scan(self):
        return self.frames("scan")

    def cli(self):
        from velocity_tpu_torch import cli

        video, annotation, _, _ = self.clip()
        args = cli.build_parser().parse_args(CLI_ARGV)
        args.video, args.annotation = video, annotation
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = args.fn(args)
        self.torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"cli speed: exit code {rc}")
        return time.perf_counter() - t0

    def stills(self):
        if self._burst is None:
            from velocity_tpu_torch.config import PipelineConfig, SolverConfig
            from velocity_tpu_torch.pipeline.stills import StillsSpeedEstimator
            from velocity_tpu_torch.testing.synthetic_clip import STILLS_BURST, render_burst

            self._burst = render_burst()
            self._stills_est = StillsSpeedEstimator(
                PipelineConfig(native_scale=STILLS_BURST["native_scale"],
                               solver=SolverConfig(dtype="float32")), device="cuda")
        res = self._stills_est.run(self._burst.stills(), annotation=self._burst.annotation,
                                   verbose=False)
        if self.cold_s is None:
            self.cold_s = res.timings["wall_s"]
        return res.timings["wall_s"]

    def entry(self, reps: int = 20):
        from graft_entry_torch import entry

        torch = self.torch
        fn, args = entry()
        fn(*args)
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return statistics.median(ms)


def worker_main(root: str) -> int:
    """Answer one JSON line on the process's first standard output for each
    part named on standard input ("warm <part>" warms it up), until EOF;
    everything else the package prints goes to standard error."""
    reply = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.path.insert(0, str(Path(root).resolve()))
    worker = Worker()
    for line in sys.stdin:
        words = line.split()
        part = words[-1]
        value = getattr(worker, part)()
        reply.write(json.dumps({"part": part, "value": value, "cold_s": worker.cold_s}) + "\n")
        reply.flush()
    return 0


class Checkout:
    """A worker process over one checkout."""

    def __init__(self, label: str, root: Path):
        self.label = label
        self.proc = subprocess.Popen([sys.executable, __file__, "--worker", str(root)],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.values: dict[str, list] = {}
        self.cold_s = None

    def ask(self, command: str) -> dict:
        self.proc.stdin.write(command + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"{self.label}: the worker ended (exit code {self.proc.wait()})")
        out = json.loads(line)
        self.cold_s = out["cold_s"]
        return out

    def measure(self, part: str):
        self.values.setdefault(part, []).append(self.ask(part)["value"])

    def close(self):
        """End the worker: EOF on its input, killed if it has not ended in a
        minute."""
        with contextlib.suppress(OSError):
            self.proc.stdin.close()
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def _quartiles(values):
    q = statistics.quantiles(values, n=4) if len(values) > 1 else [values[0]] * 3
    return {"median": statistics.median(values), "q1": q[0], "q3": q[2]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="the other checkout (default: time this one alone)")
    parser.add_argument("--pairs", type=int, default=8)
    parser.add_argument("--parts", default="frames,cli,stills",
                        help="what to time, of frames, cli, stills, scan and entry")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return worker_main(args.worker)
    parts = args.parts.split(",")
    unknown = set(parts) - set(HIGHER_IS_FASTER)
    if unknown:
        raise SystemExit(f"unknown parts {sorted(unknown)}")
    sys.path.insert(0, str(HERE))
    from velocity_tpu_torch.utils.profiling import card_line

    t0 = time.perf_counter()
    checkouts = [Checkout("change", HERE)]
    if args.parent:
        checkouts.insert(0, Checkout("parent", Path(args.parent)))
    try:
        for c in checkouts:
            for part in parts:
                c.ask(f"warm {part}")
        for k in range(args.pairs):
            for c in checkouts if k % 2 == 0 else checkouts[::-1]:
                for part in parts:
                    c.measure(part)
    finally:
        for c in checkouts:
            c.close()
    out = {"pairs": args.pairs, "seconds": time.perf_counter() - t0}
    for c in checkouts:
        out[c.label] = {"values": c.values, "stills_cold_s": c.cold_s,
                        **{part: _quartiles(v) for part, v in c.values.items()}}
    for part in parts:
        line = ", ".join(f"{c.label} {out[c.label][part]['median']:.4f} "
                         f"({out[c.label][part]['q1']:.4f}-{out[c.label][part]['q3']:.4f})"
                         for c in checkouts)
        if args.parent:
            faster = sum((ch > pa) == HIGHER_IS_FASTER[part]
                         for pa, ch in zip(checkouts[0].values[part], checkouts[1].values[part]))
            line += f"; the change faster in {faster} of {args.pairs} pairs"
            out[f"{part} change faster"] = faster
        unit = "frames/s" if HIGHER_IS_FASTER[part] else ("ms" if part == "entry" else "s")
        print(f"{part} ({unit}, median (quartiles)): {line}")
    if "stills" in parts:
        print("stills cold run (the first of each process): " + ", ".join(
            f"{c.label} {c.cold_s:.3f} s" for c in checkouts))
    print(card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
