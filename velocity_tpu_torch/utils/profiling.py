"""Profiling and observability.

Torch twin of ``velocity_tpu/utils/profiling.py``: structured per-stage
wall-clock timers, and a ``torch.profiler`` trace context for device
timelines (a Chrome trace, viewable in Perfetto or chrome://tracing).

The drivers' runs record their phases with ``StageTimer``: each
``run()`` of ``ScanSpeedRunner``, ``SpeedEstimator`` and
``StillsSpeedEstimator`` (``recorded``) opens one timer for the call on its
thread, and code below it opens nested spans with ``span(name)`` and adds
to counters with ``count(name, k)``, both of which do nothing outside a
run. A span's two stamps are ``time.time_ns()``, the clock of the
profiler's raw events, so the spans lie on the axis of a device trace; while
a profiler records, each span is also a ``record_function`` of its name and
shows in ``trace(log_dir)``'s Chrome trace. A finished run's record (its
number, spans and counters) goes into the result's ``timings["spans"]`` and
``timings["counts"]`` and into ``recent_runs()``.
Beside them, what every card number is read against: the H100's published
peaks, the least time they allow for a given work (``bound_ms``; a window
gather's and a K1 block's), a kernel timer on CUDA events (``cuda_ms``),
and the card's name and power limit as ``nvidia-smi`` reports them
(``card``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import statistics
import subprocess
import threading
import time
from collections import defaultdict, deque
from pathlib import Path

import torch

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its full
# 700 W power limit): HBM3 bandwidth, and f32 outside the tensor cores
H100_PEAK_BYTES_PER_S = 3.35e12
H100_PEAK_F32_PER_S = 67e12


def bound_ms(n_bytes: float, n_flops: float):
    """(least milliseconds, "bytes" or "operations") the H100 needs to move
    ``n_bytes`` and do ``n_flops`` f32 operations: the larger of the two
    times at the published peaks."""
    t_bytes = n_bytes / H100_PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_index(x0, y0, size: int):
    """(rows (N, size, 1), cols (N, 1, size)) of windows at corners (x0, y0)."""
    ar = torch.arange(size, device=x0.device)
    return ((y0.long()[:, None] + ar)[:, :, None], (x0.long()[:, None] + ar)[:, None, :])


def gather_bound_ms(img, rows, cols, extra_bytes: int, lane=None):
    """Bound of a window gather (K2, K3) from ``img`` at the windows of
    ``window_index``: the distinct pixels the windows cover, read once,
    plus every output word written once and ``extra_bytes``. For a stack
    ``img`` (V, H, W), ``lane`` (N,) gives each window's image."""
    H, W = img.shape[-2:]
    covered = torch.zeros(img.numel(), dtype=torch.bool, device=img.device)
    offset = rows * W + cols
    if lane is not None:
        offset = offset + (lane.long() * (H * W))[:, None, None]
    covered[offset.reshape(-1)] = True
    n_out = rows.shape[0] * rows.shape[1] * cols.shape[2]
    return bound_ms(4 * (int(covered.sum()) + n_out) + extra_bytes, 0)


def k1_bound_ms(win: int, P: int, n_taps: int, n_active: int, n_points: int):
    """Bound of one K1 block (``ops/lk_block_pallas.py:lk_block``) over
    ``n_points`` points: those active on entry read their slab and three
    windows; every point reads 12 and writes 5 f32 words. Operations per
    active point and iteration: the x-pass over win+n_taps-1 rows and the
    y-pass (one multiply-add per tap each) and the residual sums (5 per
    window pixel)."""
    from velocity_tpu_torch.ops.lk_block_pallas import BLOCK_ITERS

    n_bytes = 4 * (n_active * (P * P + 3 * win * win) + n_points * (12 + 5))
    per_iter = 2 * n_taps * win * (win + n_taps - 1) + 2 * n_taps * win * win + 5 * win * win
    return bound_ms(n_bytes, n_active * BLOCK_ITERS * per_iter)


def cuda_ms(fn, calls: int = 10, rounds: int = 5) -> float:
    """Device milliseconds per ``fn()`` call: CUDA events around ``calls``
    back-to-back calls, median over ``rounds``. A spin kernel runs first so
    that the host queues the calls ahead of the device; where the host
    still cannot keep up (the plain versions launch hundreds of small
    kernels per call) the time includes their launch cost."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / calls)
    return statistics.median(per_call)


def card_line() -> str:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` prints them
    (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"); raises where it cannot run."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card() -> dict:
    """{"name", "power_limit"} of the first card, from ``card_line``."""
    name, power_limit = (v.strip() for v in card_line().rsplit(",", 1))
    return {"name": name, "power_limit": power_limit}


class StageTimer:
    """Accumulating wall-clock stage timer and span recorder.

    with timer.stage("track"): ...
    print(timer.report())

    Each stage is also kept as a span, [name, index of the parent span
    (None at the top), start ns, end ns], nested by a stack, both stamps
    ``time.time_ns()``; ``count(name, k)`` adds to a counter. While a
    profiler records, a stage is also a ``record_function`` of its name.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)  # calls of each stage
        self.counters = defaultdict(int)
        self.spans = []
        self._open = []  # indices of the open spans, innermost last

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = False):
        index = len(self.spans)
        span = [name, self._open[-1] if self._open else None, time.time_ns(), None]
        self._open.append(index)
        self.spans.append(span)
        try:
            if torch._C._autograd._profiler_enabled():
                with torch.profiler.record_function(name):
                    yield
            else:
                yield
        finally:
            if sync and torch.cuda.is_initialized():
                # ensure device work attributed to this stage has finished
                torch.cuda.synchronize()
            span[3] = time.time_ns()
            self._open.remove(index)
            self.totals[name] += (span[3] - span[2]) / 1e9
            self.counts[name] += 1

    def count(self, name: str, k: int = 1) -> None:
        self.counters[name] += k

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


# The timer of the run open on each thread; the records of the last
# RECENT_RUNS runs of the process, oldest first, read at a benchmark's end
RECENT_RUNS = 8
_local = threading.local()
_recent: deque = deque(maxlen=RECENT_RUNS)
_run_numbers = itertools.count()


def span(name: str):
    """A span of ``name`` in the run open on this thread (a no-op outside a
    run)."""
    timer = getattr(_local, "timer", None)
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` of the run open on this thread (a
    no-op outside a run)."""
    timer = getattr(_local, "timer", None)
    if timer is not None:
        timer.count(name, k)


def spanned(name: str):
    """Decorate a function: each call inside a run is a span of ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def spans_over(items, name: str, first: str | None = None):
    """Yield ``items``, each inside a span of ``name`` (the first one inside
    a span of ``first`` where given) that closes before the next is taken:
    a loop's bodies as spans, its iterator's work between them."""
    for k, item in enumerate(items):
        with span(first if k == 0 and first is not None else name):
            yield item


def recent_runs() -> list:
    """The records of the last ``RECENT_RUNS`` runs, oldest first:
    {"run": the process's run number, "spans": [(name, parent, start ns,
    end ns)], "counts": {name: total}}."""
    return list(_recent)


def recorded(run):
    """Decorate a driver's ``run`` method: the call is one ``run`` span of a
    timer of its own, and its record goes into the returned result's
    ``timings["spans"]`` and ``timings["counts"]`` and into
    ``recent_runs()``. A run called inside another run (the scan runner
    handing a clip to the per-frame driver) records into the outer run."""

    @functools.wraps(run)
    def call(*args, **kwargs):
        if getattr(_local, "timer", None) is not None:
            return run(*args, **kwargs)
        timer = _local.timer = StageTimer()
        try:
            with timer.stage("run"):
                res = run(*args, **kwargs)
        finally:
            _local.timer = None
            record = {"run": next(_run_numbers), "spans": [tuple(s) for s in timer.spans],
                      "counts": dict(timer.counters)}
            _recent.append(record)
        res.timings["spans"] = record["spans"]
        res.timings["counts"] = record["counts"]
        return res

    return call


@contextlib.contextmanager
def trace(log_dir: str | Path | None):
    """Profiler trace context: host ops, and device kernels where CUDA is
    initialised, written to ``log_dir/trace.json`` on exit (no-op when
    ``log_dir`` is None). The spans of a run inside it show as
    ``record_function`` ranges of their names."""
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
