"""Share of the traced window in which no operation ran on the card: the
reader of every ``idle_frac.<loop>`` metric, one name for each end-to-end
metric it moves."""


def read(run):
    t = run.trace
    if t is None or not t.window_s:
        return None
    return 1.0 - t.busy_s / t.window_s
