"""idle_unspanned_pct: the share of the card's idle time, inside the run of
the clip traced with CUDA activity alone, that no span of the program below
``run`` covers: 100 x (idle ns inside ``run`` outside every child span) /
(idle ns inside ``run``). The run is the one of
``profiling.recent_runs()`` whose ``run`` span overlaps the trace's device
activity most; its stamps and the trace's are on one clock
(``time.time_ns()``). ``by_span(run)`` splits the idle ms by the innermost
span around it (``run`` where none is)."""

import bisect
import itertools

from benchmark.trace import _merged


def _traced_record(run):
    """The spans of the program's run that the traced clip ran, or None."""
    from velocity_tpu_torch.utils import profiling

    recent = getattr(profiling, "recent_runs", None)
    tr = run.trace
    if recent is None or tr is None or not tr.device:
        return None
    lo = min(s for _n, s, _e, _c in tr.device)
    hi = max(e for _n, _s, e, _c in tr.device)
    best, overlap = None, 0
    for rec in recent():
        root = next((s for s in rec["spans"] if s[1] is None and s[3] is not None), None)
        ov = min(hi, root[3]) - max(lo, root[2]) if root else 0
        if ov > overlap:
            best, overlap = rec["spans"], ov
    return best


class _Idle:
    """Idle ns of the card inside any host interval, from the trace's busy
    union."""

    def __init__(self, device):
        busy = _merged((s, e) for _n, s, e, _c in device)
        self.starts = [s for s, _e in busy]
        self.ends = [e for _s, e in busy]
        self.cum = list(itertools.accumulate(e - s for s, e in busy))

    def _busy_before(self, x):
        i = bisect.bisect_right(self.starts, x)
        return self.cum[i - 1] - max(0, self.ends[i - 1] - x) if i else 0

    def within(self, a, b):
        return (b - a) - (self._busy_before(b) - self._busy_before(a))


def _own_idle(run):
    """(spans, [idle ns inside each span outside its children], [idle ns
    inside each span]) of the traced clip's run, or Nones."""
    spans = _traced_record(run)
    if spans is None or any(s[3] is None for s in spans):
        return None, None, None
    idle = _Idle(run.trace.device)
    within = [idle.within(s[2], s[3]) for s in spans]
    own = list(within)
    for s, ns in zip(spans, within):
        if s[1] is not None:
            own[s[1]] -= ns
    return spans, own, within


def by_span(run) -> dict | None:
    """{span name: idle ms of the card inside its spans, outside their
    children}, largest first."""
    spans, own, _w = _own_idle(run)
    if spans is None:
        return None
    by = {}
    for s, ns in zip(spans, own):
        by[s[0]] = by.get(s[0], 0.0) + ns / 1e6
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def read(run):
    spans, own, within = _own_idle(run)
    if spans is None:
        return None
    root = next(j for j, s in enumerate(spans) if s[1] is None)
    return 100.0 * own[root] / within[root] if within[root] > 0 else None
