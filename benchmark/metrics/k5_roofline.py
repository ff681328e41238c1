"""k5_roofline: K5's (``ops/lk_lanes.py:extract_warped``, stage 3's
warped windows, ``csrc/warp_window.cu``) share of its roofline in the
traced clip: the sum over its launches of the least time the card needs
for each, over K5's device time in the trace.

A launch over N points writes N (P, P) float32 patches and the (2, N)
float32 corner, and reads each point's (2, 3) map and centre. Its least
time is the bytes it must write at the H100's published 3.35 TB/s
(``bytes`` bound). The window pixels it reads are left out, as
``k2_roofline`` leaves them out: the windows overlap, so counting each
window's pixels would pass the union that a kernel must read, and the
counter does not record where the windows lie. The counter
(``ops/launches.py``, ``"extract_warped"``) keys K5's launches by (P, Q);
N is the configuration's capacity, ``max_features``. K5's kernel is
``warp_window``. A program without K5 (no such counter) reads nothing."""

PEAK_BYTES_PER_S = 3.35e12


def least_s(P: int, n: int) -> float:
    return (4 * n * P * P + 8 * n) / PEAK_BYTES_PER_S


def read(run):
    tr, counts = run.trace, run.launches
    if tr is None or counts is None or "extract_warped" not in counts:
        return None
    n = run.pcfg.tracker.max_features
    least = sum(m * least_s(shape[0], n) for shape, m in counts["extract_warped"][1].items())
    ns = sum(e - s for name, s, e, _c in tr.device if "warp_window" in name)
    return 100.0 * least / (ns / 1e9) if ns and least else None
