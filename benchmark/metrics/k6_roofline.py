"""k6_roofline: K6's (``ops/lk_lanes.py:source_window``, the LK source
window of each pyramid level, ``csrc/source_window.cu``) share of its
roofline in the traced clip: the sum over its launches of the least time
the card needs for each, over K6's device time in the trace.

A launch over N points writes Ip, gx and gy (N x win x win float32 each),
a11, a12, a22 and inv_det (N float32 each) and trackable (N bytes). Its
least time is those bytes at the H100's published 3.35 TB/s (``bytes``
bound). The slab pixels it reads are left out, as ``k2_roofline`` and
``k5_roofline`` leave them out: the slabs overlap, so counting each slab's
pixels would pass the union that a kernel must read, and the counter does
not record where the slabs lie. The counter (``ops/launches.py``,
``"source_window"``) keys K6's launches by (win, P, cubic); N is the
configuration's capacity, ``max_features``. K6's kernels are named
``source_window_warp`` and ``source_window_block``. A program without K6
(no such counter) reads nothing."""

PEAK_BYTES_PER_S = 3.35e12


def least_s(win: int, n: int) -> float:
    return (4 * n * (3 * win * win + 4) + n) / PEAK_BYTES_PER_S


def read(run):
    tr, counts = run.trace, run.launches
    if tr is None or counts is None or "source_window" not in counts:
        return None
    n = run.pcfg.tracker.max_features
    least = sum(m * least_s(shape[0], n) for shape, m in counts["source_window"][1].items())
    ns = sum(e - s for name, s, e, _c in tr.device if "source_window" in name)
    return 100.0 * least / (ns / 1e9) if ns and least else None
