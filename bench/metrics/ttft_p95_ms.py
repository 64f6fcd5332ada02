"""95th percentile (nearest rank) of time to first token over every
request due in the window, timed from its scheduled arrival.  A request
with no first token when the window closes enters at its wait so far, so
a stall cannot hide."""
from harness.stats import nearest_rank


def read(run):
    S = run.log.seconds
    waits = [(r.times[0] if r.times else S) - r.arrive
             for r in run.log.records.values() if 0 <= r.arrive <= S]
    p = nearest_rank(waits, 95)
    return None if p is None else p * 1e3
