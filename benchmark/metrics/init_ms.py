"""init_ms: the scan runner's frame-0 init (Harris, ``corner_subpix``, the
host f64 plate geometry), ms a clip: the mean over the window's clips of
``timings["init_s"] - timings["decode_s"]`` (``init_s`` counts from the
start of the run)."""


def read(run):
    v = [c["timings"]["init_s"] - c["timings"]["decode_s"] for c in run.clips
         if "init_s" in c["timings"] and "decode_s" in c["timings"]]
    return 1e3 * sum(v) / len(v) if v else None
