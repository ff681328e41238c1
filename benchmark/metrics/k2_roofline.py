"""k2_roofline: K2's (``ops/slab_pallas.py:extract_slabs``, ``csrc/slab.cu``)
share of its roofline in the traced clip: the sum over its launches of the
least time the card needs for each, over K2's device time in the trace.

A launch of N windows of S x S pixels writes N S^2 float32 words and reads
N corners and writes them clamped (2 int32 words each). Its least time is
those bytes at the H100's published 3.35 TB/s (``bytes`` bound; K2 does no
arithmetic). The pixels it reads are left out: the windows overlap, so
counting each window's pixels would pass the union that a kernel must read,
and the counter does not record where the windows lie. The counter
(``ops/launches.py``) keys K2's launches by S; N is the configuration's
capacity: ``max_features`` in the frame step, and ``max_features - 4``
corners where ``corner_subpix`` refines the frame-0 (or replenished) corners
in slabs of ``4 * subpix_window + 7`` pixels. K2's kernels are the window
gather's (``gather_windows``), which K3 shares: where K3 launched in the
traced clip the time cannot be split, and nothing is read."""

PEAK_BYTES_PER_S = 3.35e12


def least_s(size: int, n: int) -> float:
    return (4 * n * size * size + 16 * n) / PEAK_BYTES_PER_S


def read(run):
    tr, counts = run.trace, run.launches
    if tr is None or counts is None or counts["extract_patches"][0]:
        return None
    tracker = run.pcfg.tracker
    subpix = 4 * tracker.subpix_window + 7
    least = sum(m * least_s(s, tracker.max_features - 4 if s == subpix else tracker.max_features)
                for s, m in counts["extract_slabs"][1].items())
    ns = sum(e - s for name, s, e, _c in tr.device if "gather_windows" in name)
    return 100.0 * least / (ns / 1e9) if ns and least else None
