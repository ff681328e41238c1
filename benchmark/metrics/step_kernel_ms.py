"""step_kernel_ms: device time of one replay of the captured frame step: the
device time of the kernels that graph launches put on the card in the traced
clip, over the replays counted there (``step_graphs()[...].replays``)."""


def read(run):
    tr = run.trace
    if tr is None or not run.replays or not tr.graph_launches:
        return None
    ns = sum(e - s for _n, s, e, c in tr.device if c in tr.graph_launches)
    return ns / 1e6 / run.replays if ns else None
