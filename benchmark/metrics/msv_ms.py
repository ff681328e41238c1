"""msv_ms: the scan runner's host MSV re-anchor, ms a clip: the mean over
the window's clips of ``timings["msv_s"]``."""


def read(run):
    v = [c["timings"]["msv_s"] for c in run.clips if "msv_s" in c["timings"]]
    return 1e3 * sum(v) / len(v) if v else None
