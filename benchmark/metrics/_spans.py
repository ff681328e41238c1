"""What the span metrics share: each clip's record of the program's spans
and counters (``timings["spans"]``, ``timings["counts"]``, written by
``velocity_tpu_torch/utils/profiling.py``). A program that records none
leaves them out, and every reader then returns None."""

import statistics


def records(run) -> list:
    """(spans, counts) of each of the window's clips that carries a record;
    a span is (name, index of its parent or None, start ns, end ns)."""
    return [(c["timings"]["spans"], c["timings"].get("counts", {}))
            for c in run.clips if "spans" in c["timings"]]


def ms(span) -> float:
    return (span[3] - span[2]) / 1e6


def mean_total_ms(run, name: str):
    """The mean over the window's clips of each clip's spans of ``name``,
    summed, in ms."""
    per_clip = [sum(ms(s) for s in spans if s[0] == name) for spans, _c in records(run)]
    return statistics.fmean(per_clip) if per_clip else None


def frames_after_msv(run) -> list:
    """[(the frame span, its children)] of every frame after the MSV frame
    in the window's clips: a per-frame driver's frame k >= 1 is its k-th
    ``frame`` span (frame 0 is ``init``)."""
    out = []
    for spans, _c in records(run):
        frames = [j for j, s in enumerate(spans) if s[0] == "frame"]
        for j in frames[run.pcfg.msv_frame:]:
            out.append((spans[j], [s for s in spans if s[1] == j]))
    return out
