"""Every output token the engine emitted inside the window, over the
window's length."""


def read(run):
    S = run.log.seconds
    n = sum(sum(1 for t in r.times if 0 <= t <= S)
            for r in run.log.records.values())
    return n / S
