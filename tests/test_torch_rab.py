"""Host-side parity: the port's RAB + PagedKVPool, backing store and tracer
against the reference's, driven by the same seeded random op schedules."""
import numpy as np
import pytest

from repro.core import offload as JO
from repro.core import rab as JR
from repro.core import tracing as JT
from repro_torch.core import offload as TO
from repro_torch.core import rab as TR
from repro_torch.core import tracing as TT


def _state(pool):
    return dict(
        page_table=dict(pool.page_table), seq_len=dict(pool.seq_len),
        reserved=dict(pool.reserved), refcount=dict(pool.refcount),
        free=list(pool.free), cached_free=list(pool.cached_free),
        prefix_index=dict(pool.prefix_index), stats=dict(pool.stats),
        rab=dict(pool.rab.stats), table=pool.block_table(
            sorted(pool.seq_len)).tolist())


def _schedule(seed, n_ops=300, page=4, num_pages=24):
    """One op schedule applied to both pools; returns both pools' state
    after every op."""
    rng = np.random.default_rng(seed)
    cfg = dict(l1_entries=4, l2_entries=8, l2_assoc=2, l2_banks=2)
    jt, tt = JT.TraceBuffer(), TT.TraceBuffer()
    pools = [JR.PagedKVPool(num_pages, page, 8,
                            JR.RAB(JR.RABConfig(**cfg), jt)),
             TR.PagedKVPool(num_pages, page, 8,
                            TR.RAB(TR.RABConfig(**cfg), tt))]
    tokens = {}             # seq -> prompt tokens (a few shared prefixes)
    prefixes = [list(rng.integers(0, 50, 9)) for _ in range(3)]
    next_seq = 0
    live = []
    out = []
    for _ in range(n_ops):
        op = rng.choice(["admit", "append", "append", "append", "register",
                         "trim", "release", "translate"])
        if op == "admit" or not live:
            s, next_seq = next_seq, next_seq + 1
            toks = prefixes[rng.integers(3)] + \
                list(rng.integers(0, 50, rng.integers(1, 6)))
            tokens[s] = toks
            need = int(rng.integers(1, 5))
            ok = [p.available() >= need + 3 for p in pools]
            assert ok[0] == ok[1]
            if ok[0]:
                hits = [p.match_prefix(toks) for p in pools]
                assert hits[0] == hits[1]
                pages, n = hits[0]
                for p in pools:
                    p.reserve(s, need)
                    for lp, pp in enumerate(pages[:n // page]):
                        p.share_page(s, lp, pp)
                    if n // page:
                        p.seq_len[s] = (n // page) * page
                live.append(s)
            else:
                # pool pressure: retire the oldest sequence instead
                for p in pools:
                    p.release(live[0])
                live.pop(0)
        s = int(rng.choice(live)) if live else -1
        if s < 0 or op == "admit":
            pass
        elif op == "append":
            for _ in range(int(rng.integers(1, 4))):
                try:
                    got = [p.append_token(s) for p in pools]
                except MemoryError:
                    break
                assert got[0] == got[1]
                cows = [p.drain_cow() for p in pools]
                assert cows[0] == cows[1]
        elif op == "register":
            n = min(pools[0].seq_len.get(s, 0), len(tokens[s]))
            for lp in range(n // page):
                for p in pools:
                    p.register_page(s, lp, tokens[s])
        elif op == "trim":
            n = pools[0].seq_len.get(s, 0)
            k = int(rng.integers(0, n + 1))
            assert pools[0].trim(s, k) == pools[1].trim(s, k)
        elif op == "release":
            for p in pools:
                p.release(s)
            live.remove(s)
        else:
            n = pools[0].seq_len.get(s, 0)
            for lp in range(-(-n // page)):
                assert pools[0].translate(s, lp) == pools[1].translate(s, lp)
        for p in pools:
            p.check_invariants()
        out.append((_state(pools[0]), _state(pools[1])))
    assert jt.drain().tolist() == tt.drain().tolist()
    return out


@pytest.mark.parametrize("seed", range(4))
def test_pool_schedules_match_reference(seed):
    states = _schedule(seed)
    assert states
    for ref, port in states:
        assert port == ref


def test_backing_store_matches_reference():
    rng = np.random.default_rng(7)
    stores = [JO.HostBackingStore(host_pages=3),
              TO.HostBackingStore(host_pages=3)]
    pages = [rng.integers(-2 ** 15, 2 ** 15, (2, 4, 2, 8)).astype(np.int16)
             for _ in range(6)]
    for st in stores:
        for lp, pg in enumerate(pages[:4]):
            st.put(0, lp, pg)
        st.park_cache(11, pages[4])
        st.park_cache(12, pages[5])
    assert [len(s) for s in stores] == [4, 4]
    got = [[s.pop(0, lp) for lp in (2, 0)] for s in stores]
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)
    for s in stores:
        s.repark(0, 2, got[0][0])
        s.discard(0)
    assert [s.cache_resident() for s in stores][0] == \
        stores[1].cache_resident()
    assert [(s.bytes_out, s.bytes_in, s.cache_bytes_demoted)
            for s in stores][0] == (stores[1].bytes_out, stores[1].bytes_in,
                                    stores[1].cache_bytes_demoted)
    for s, E in zip(stores, (JO.BackingStoreError, TO.BackingStoreError)):
        with pytest.raises(E, match="missing"):
            s.pop(0, 1)
        s.check_invariants()


def test_event_types_and_trace_match_reference():
    assert {e.name: int(e) for e in TT.EventType} == \
        {e.name: int(e) for e in JT.EventType}
    assert TT.HOST_TRACER_ID == JT.HOST_TRACER_ID
    bufs = [JT.TraceBuffer(), TT.TraceBuffer()]
    for b in bufs:
        b.record_host(JT.EventType.H2D, 3, 0)
        b.record_host(TT.EventType.SWAP_IN, 7, 2)
    assert bufs[0].drain().tolist() == bufs[1].drain().tolist()
    assert bufs[1].drain().shape == (0, 5)
