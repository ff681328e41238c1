"""setup_s: from process start to the first timed call: imports, rendering
the pool, the warm-up clip (kernel loads and builds, graph captures)."""


def read(run):
    return run.setup_s
