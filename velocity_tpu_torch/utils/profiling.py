"""Profiling and observability.

Torch twin of ``velocity_tpu/utils/profiling.py``: structured per-stage
wall-clock timers, and a ``torch.profiler`` trace context for device
timelines (a Chrome trace, viewable in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


class StageTimer:
    """Accumulating wall-clock stage timer.

    with timer.stage("track"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_initialized():
                # ensure device work attributed to this stage has finished
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{'stage':<24}{'total_s':>10}{'calls':>8}{'ms/call':>10}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:<24}{tot:>10.3f}{n:>8d}{1e3 * tot / n:>10.2f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k]}
            for k in self.totals
        }


@contextlib.contextmanager
def trace(log_dir: str | Path | None):
    """Profiler trace context: host ops, and device kernels where CUDA is
    initialised, written to ``log_dir/trace.json`` on exit (no-op when
    ``log_dir`` is None)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
