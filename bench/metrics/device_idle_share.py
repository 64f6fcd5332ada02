"""One minus the union of the device's kernel, copy and set intervals
over the profiled sub-window's length."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
