"""The driver's closed loop on a tiny model on the CPU: the clients start
one by one over the lead-in, each sends its next request when its last one
finishes, and the result line carries the pool pages the window held."""
import pytest

import tinycell

CLOSED = {"loop": "closed", "clients": 4, "block": 4,
          "prompt": {"dist": "lognormal", "median": 16, "sigma": 0.6,
                     "min": 8, "max": 40},
          "output": {"dist": "uniform", "min": 4, "max": 12}}


@pytest.fixture(scope="module")
def closed_run():
    c = tinycell.cell(mix=CLOSED)
    c.spec["lead_in_s"] = 1.0
    return tinycell.run(c, seed=17)


def test_clients_start_one_by_one_over_the_lead_in(closed_run):
    log = closed_run["_run"].log
    starts = [-1.0, -0.75, -0.5, -0.25]
    arrive = sorted(r.arrive for r in log.records.values())
    assert [t for t in arrive if t in starts] == starts
    # every other request is sent when another one finished, at that time
    finished = {r.finish for r in log.records.values()
                if r.finish is not None}
    later = [r for r in log.records.values() if r.arrive not in starts]
    assert len(later) > 4 and all(r.arrive in finished for r in later)
    assert closed_run["correct"], closed_run["checks"]


def test_the_line_carries_the_pages_the_window_held(closed_run):
    dev = closed_run["device"]
    assert 0 < dev["pool_pages_live_peak"] <= dev["pool_pages_held_peak"] \
        <= dev["pool_pages"]
