"""A device trace of one traced call, read straight from the profiler's
results.

``torch.profiler`` builds a Python object per event when its results are
read, which takes minutes for the million events of a clip whose every
frame replays a graph of some 13,000 kernels. This module starts and stops
the same profiler and reads its raw events: each device activity's name,
span and correlation id, and, where host ops are recorded, each one's name
and span.

Recording host ops slows the host's side of a clip (every torch op takes a
record), which would show as device idle time. So a traced run traces two
clips: one with CUDA activity alone (CUPTI), which the device metrics read,
and one with host ops as well, which only names the idle gaps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    window_s: float = 0.0  # host wall of the traced window
    busy_s: float = 0.0  # union of device activity
    device: list = field(default_factory=list)  # (name, start_ns, end_ns, correlation)
    host: list = field(default_factory=list)  # (name, start_ns, end_ns) of CPU ops
    graph_launches: set = field(default_factory=set)  # correlation ids of cudaGraphLaunch

    def device_ops(self, top: int = 10) -> list:
        """[[kernel name, seconds]] of the device activities that took most."""
        by = {}
        for name, s, e, _c in self.device:
            by[name] = by.get(name, 0) + (e - s)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, top: int = 10, longest: int = 500) -> list:
        """[[what the host was doing, seconds]]: the ``longest`` idle gaps
        of the device, each named by the innermost host op running at its
        middle, summed by name."""
        import numpy as np

        spans = _merged((s, e) for _n, s, e, _c in self.device)
        gaps = sorted(((s1 - e0, (e0 + s1) / 2) for (_s0, e0), (s1, _e1)
                       in zip(spans, spans[1:])), reverse=True)[:longest]
        names = [h[0] for h in self.host]
        starts = np.array([h[1] for h in self.host], np.float64)
        ends = np.array([h[2] for h in self.host], np.float64)
        by = {}
        for length, mid in gaps:
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = (names[inside[np.argmin(ends[inside] - starts[inside])]] if len(inside)
                    else "no torch op (Python)")
            by[name] = by.get(name, 0) + length
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]


def _merged(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_ns(spans) -> int:
    """Length of the union of (start, end) spans."""
    return int(sum(e - s for s, e in _merged(spans)))


def _start(host: bool):
    from torch.autograd import ProfilerActivity
    from torch.autograd import profiler as ap

    try:
        p = ap.profile(use_device="cuda", use_kineto=True)
    except TypeError:
        p = ap.profile(use_cuda=True, use_kineto=True)
    if not host:
        p.kineto_activities = {ProfilerActivity.CUDA}
    p._prepare_trace()
    p._start_trace()
    return p


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    return f() if f is not None else getattr(ev, f"{what}_us")() * 1000


def traced(fn, host: bool = False):
    """Run ``fn()`` under the profiler, recording CUDA activity and, with
    ``host``, host ops; returns (its result, ``Trace``)."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    _start(host)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    res = torch._C._autograd._disable_profiler()
    tr = Trace(window_s=window)
    for ev in res.events():
        name = ev.name()
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation():
                continue
            tr.device.append((name, start, end, ev.correlation_id()))
        elif name.startswith("cudaGraphLaunch"):
            tr.graph_launches.add(ev.correlation_id())
        elif not name.startswith("cuda") and not ev.is_user_annotation():
            tr.host.append((name, start, end))
    tr.busy_s = union_ns((s, e) for _n, s, e, _c in tr.device) / 1e9
    return out, tr
