"""device_idle_pct: the share of the traced clip's wall in which no
operation ran on the card: 100 x (1 - the union of device activity over the
window). The clip is traced with CUDA activity alone; CUPTI's records still
slow its host side, so the share reads above an untraced clip's."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
