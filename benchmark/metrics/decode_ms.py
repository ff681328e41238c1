"""decode_ms: the scan runner's decode into its pinned stack, ms a clip:
the mean over the window's clips of ``timings["decode_s"]``."""


def read(run):
    v = [c["timings"]["decode_s"] for c in run.clips if "decode_s" in c["timings"]]
    return 1e3 * sum(v) / len(v) if v else None
