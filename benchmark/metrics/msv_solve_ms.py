"""msv_solve_ms: the MSV's solve in the re-anchor (``solvers/triangulate.py:
msv_refine_translation``, host f64: the ray intercept and its LM over the
newest camera), ms a clip: the mean over the window's clips of the span
``reanchor.msv``. A program that records no such span gives no reading."""

import statistics

from benchmark.metrics import _spans


def read(run):
    per_clip = [sum(_spans.ms(s) for s in spans if s[0] == "reanchor.msv")
                for spans, _c in _spans.records(run)
                if any(s[0] == "reanchor.msv" for s in spans)]
    return statistics.fmean(per_clip) if per_clip else None
