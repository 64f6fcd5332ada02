"""The general traffic generator: deterministic for a seed, the same
stratified sizes for every seed, the stated distributions."""
import itertools
import json
import math
import statistics

import tinycell  # noqa: F401  (puts the harness on sys.path)
from harness import traffic

MIXES = tinycell.BENCH / "traffic"


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def take(m, seed, n, rate=3.0):
    return list(itertools.islice(traffic.requests(m, seed, 64000, rate), n))


def test_same_seed_same_requests():
    for name in ("rag", "sysprompt", "chat"):
        a = take(mix(name), 2**40 + 3, 130)
        b = take(mix(name), 2**40 + 3, 130)
        assert a == b
        assert a != take(mix(name), 2**40 + 4, 130)


def test_every_seed_offers_the_same_sizes_and_gaps():
    m = mix("rag")
    n = m["block"] * 2
    runs = [take(m, s, n) for s in (1, 99, 2**33 + 5)]
    for rs in runs[1:]:
        assert sorted(len(r.prompt) for r in rs) == \
            sorted(len(r.prompt) for r in runs[0])
        assert sorted(r.max_new for r in rs) == \
            sorted(r.max_new for r in runs[0])
        assert math.isclose(rs[-1].t, runs[0][-1].t, rel_tol=1e-9)
    # the order differs
    assert [len(r.prompt) for r in runs[0]] != [len(r.prompt) for r in runs[1]]


def test_rag_lengths_follow_the_lognormal_and_the_clip():
    m = mix("rag")
    rs = take(m, 5, 64 * 16)
    lens = [len(r.prompt) for r in rs]
    assert min(lens) >= 256 and max(lens) <= 3968
    assert abs(statistics.median(lens) - 1536) <= 16
    # sigma 0.6: the 84th percentile sits at median * e^0.6
    q84 = sorted(lens)[int(0.8413 * len(lens))]
    assert abs(q84 / (1536 * math.exp(0.6)) - 1) < 0.03
    outs = [r.max_new for r in rs]
    assert min(outs) >= 16 and max(outs) <= 128
    assert abs(statistics.mean(outs) - 72) < 1.5


def test_open_loop_rate():
    rs = take(mix("rag"), 11, 64 * 4, rate=3.0)
    assert abs(len(rs) / rs[-1].t - 3.0) / 3.0 < 0.05
    assert all(b.t > a.t for a, b in zip(rs, rs[1:]))


def test_sysprompt_prefixes_follow_zipf():
    m = mix("sysprompt")
    rs = take(m, 17, m["prefix"]["block"])
    shared = traffic.shared_prompts(m, 17, 64000)
    assert len(shared) == 8 and all(len(p) == 2048 for p in shared)
    counts = [sum(1 for r in rs if r.prefix == k) for k in range(8)]
    assert counts == traffic.zipf_counts(8, 1.0, m["prefix"]["block"])
    assert counts[0] > counts[1] > counts[3] > counts[7] >= 1
    for r in rs:
        assert r.prompt[:2048] == tuple(int(x) for x in shared[r.prefix])
        assert 32 <= len(r.prompt) - 2048 <= 512


def test_chat_is_a_closed_loop_of_64():
    m = mix("chat")
    assert m["loop"] == "closed" and m["clients"] == 64
    rs = take(m, 3, 128)
    assert all(r.t == 0.0 for r in rs)
    assert min(r.max_new for r in rs) >= 256
    assert max(r.max_new for r in rs) <= 1024


def test_zipf_counts_sum_and_order():
    c = traffic.zipf_counts(8, 1.0, 100)
    assert sum(c) == 100 and c == sorted(c, reverse=True)
