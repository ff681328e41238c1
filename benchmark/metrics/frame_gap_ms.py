"""frame_gap_ms: a per-frame driver's time per frame after the MSV frame:
the median, over the window's clips and their frames after the MSV frame,
of the host time between two successive pulls from the benchmark's reader
(a frame's upload, replay, reads and host work, and the next pull)."""

import statistics


def read(run):
    msv = run.pcfg.msv_frame
    gaps = [b - a for c in run.clips for a, b in zip(c["pulls"][msv + 1:], c["pulls"][msv + 2:])]
    return 1e3 * statistics.median(gaps) if gaps else None
