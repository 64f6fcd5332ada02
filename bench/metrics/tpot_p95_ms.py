"""95th percentile (nearest rank), over requests with at least two output
tokens in the window, of each request's mean gap between its output
tokens in the window."""
from harness.stats import nearest_rank


def read(run):
    S = run.log.seconds
    gaps = []
    for r in run.log.records.values():
        ts = [t for t in r.times if 0 <= t <= S]
        if len(ts) >= 2:
            gaps.append((ts[-1] - ts[0]) / (len(ts) - 1))
    p = nearest_rank(gaps, 95)
    return None if p is None else p * 1e3
