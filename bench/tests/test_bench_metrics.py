"""Metric readers on hand-built windows: the percentile takes censored
waits, tokens per second is the whole window's, the step shares count
every row."""
import tinycell
from harness.cell import read_metric
from harness.counts import Geometry
from harness.driver import Iteration, Log, Record
from harness.stats import nearest_rank


class Run:
    def __init__(self, log, lanes=4, chunk=8, trace=None):
        self.log, self.lanes, self.chunk, self.trace = log, lanes, chunk, \
            trace
        self.geometry = Geometry(layers=2, d=8, heads=2, kv_heads=1, hd=4,
                                 vocab=16, ff=16)
        self.kv_bytes = 2
        self.setup_s = 12.5


def rec(rid, arrive, times, prompt=4, hit=0, hit_t=None):
    return Record(rid=rid, prompt=(1,) * prompt, max_new=len(times) or 1,
                  arrive=arrive, hit=hit, hit_t=hit_t,
                  tokens=[0] * len(times), times=list(times))


def read(name, log, **kw):
    return read_metric(name, Run(log, **kw), tinycell.ROOT)


def test_nearest_rank():
    xs = list(range(1, 101))
    assert nearest_rank(xs, 95) == 95
    assert nearest_rank([3.0], 95) == 3.0
    assert nearest_rank([], 95) is None
    assert nearest_rank(range(1, 21), 95) == 19


def test_ttft_counts_a_request_without_a_first_token_at_its_wait():
    recs = {i: rec(i, 1.0, [1.5]) for i in range(19)}
    recs[19] = rec(19, 2.0, [])               # stalled: waits 10 - 2 = 8 s
    recs[20] = rec(20, -1.0, [0.5])           # due before the window
    log = Log(seconds=10.0, records=recs, iterations=[])
    # 20 requests due; nearest rank 95 is the 19th smallest: 0.5 s, and
    # the censored wait is the largest
    assert read("ttft_p95_ms", log) == 500.0
    recs[18] = rec(18, 1.0, [])               # a second stall: 9 s
    assert read("ttft_p95_ms", log) == 8000.0


def test_tokens_per_second_is_the_whole_window():
    recs = {0: rec(0, -3.0, [-1.0, 0.5, 1.0, 9.9, 10.5]),
            1: rec(1, 4.0, [6.0, 7.0])}
    log = Log(seconds=10.0, records=recs, iterations=[])
    # 0.5, 1.0, 9.9 and 6.0, 7.0 are inside [0, 10]
    assert read("output_tokens_per_s", log) == 0.5


def test_tpot_is_the_mean_gap_inside_the_window():
    recs = {0: rec(0, -3.0, [-1.0, 1.0, 2.0, 3.0]),
            1: rec(1, 4.0, [6.0, 9.0]),
            2: rec(2, 4.0, [8.0])}
    log = Log(seconds=10.0, records=recs, iterations=[])
    assert read("tpot_p95_ms", log) == 3000.0


def test_padded_rows_and_prefix_hits():
    its = [Iteration(t0=0, t1=1, prefill_fed=10, decode=[(0, 5)]),
           Iteration(t0=1, t1=2, prefill_fed=0,
                     decode=[(0, 6), (1, 7), (2, 8)])]
    recs = {0: rec(0, 0.5, [1.0], hit=30, hit_t=0.6),
            1: rec(1, -2.0, [0.1], hit=99, hit_t=-1.0)}
    log = Log(seconds=10.0, records=recs, iterations=its)
    # rows: 4 x 8 + 4 x 1 = 36, carried 10 + 1 + 3 = 14
    assert read("padded_row_share", log) == (36 - 14) / 36
    # the hit before the window does not count
    assert read("prefix_hit_share", log) == 30 / 40


def test_iteration_walls_by_kind():
    its = [Iteration(t0=0, t1=0.2, prefill_fed=5, decode=[]),
           Iteration(t0=0.2, t1=0.25, prefill_fed=0, decode=[(0, 1)]),
           Iteration(t0=0.25, t1=0.32, prefill_fed=0, decode=[(0, 2)]),
           Iteration(t0=0.32, t1=0.9, prefill_fed=0, decode=[(0, 3)],
                     traced=True)]
    log = Log(seconds=1.0, records={}, iterations=its)
    assert abs(read("prefill_iter_ms", log) - 200.0) < 1e-9
    assert abs(read("decode_iter_ms", log) - 60.0) < 1e-9


def test_serve_mfu_counts_computed_tokens_only():
    g = Run(None).geometry
    n2 = 2 * (2 * (8 * 4 * 6 + 3 * 8 * 16))    # 2 x active params
    key, head = 4 * 4 * 2 * 2, 2 * 8 * 16
    # prompt 4 with 2 hit tokens, first token at 1.0, then two more:
    # prompt positions 2, 3; decode positions 4, 5
    recs = {0: rec(0, 0.5, [1.0, 2.0, 3.0], hit=2, hit_t=0.6)}
    log = Log(seconds=10.0, records=recs, iterations=[])
    flops = 2 * n2 + key * (3 + 4) + 2 * n2 + key * (5 + 6) + 3 * head
    got = read("serve_mfu", log)
    assert abs(got - 100.0 * flops / (10.0 * 989e12)) < 1e-18
    assert g.layers == 2


def test_setup_is_reported_as_measured():
    assert read("setup_s", Log(seconds=1.0, records={}, iterations=[])) \
        == 12.5
