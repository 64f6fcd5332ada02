"""The reference's RAB property tests (``tests/test_rab_properties.py``) on
the port's ``RAB`` and ``PagedKVPool``.

Each hypothesis property runs its access pattern on the reference's
object and on the port's side by side: the port must keep the property
(a completed translation is the page-table value, resident entries are a
subset of the page table, the pool never double-maps a page), and after
every operation both must hold the same state (each lookup's result and
latency, RAB statistics and resident entries; the pool's page table,
free list, sequence lengths, raised ``MemoryError``s and statistics).

Skipped wholesale when hypothesis is not installed, as the reference's
suite is.
"""
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import rab as JR  # noqa: E402
from repro_torch.core import rab as TR  # noqa: E402

CFG = dict(l1_entries=4, l2_entries=16, l2_assoc=4, l2_banks=2)


def _rabs():
    return JR.RAB(JR.RABConfig(**CFG)), TR.RAB(TR.RABConfig(**CFG))


def _rab_state(rab) -> dict:
    return {"stats": dict(rab.stats), "resident": dict(rab.resident())}


@settings(deadline=None)
@given(st.lists(st.integers(0, 30), min_size=1, max_size=120))
def test_translation_always_correct(vpages):
    """A translation that completes always returns the page-table value,
    on both RABs, with the same results, latencies and state."""
    ref, port = _rabs()
    pt = {v: v * 7 + 1 for v in range(31)}
    for i, v in enumerate(vpages):
        got = []
        for rab in (ref, port):
            p, lat = rab.lookup(v, requester=i % 8)
            first = (p, lat)
            if p is None:
                rab.handle_misses(pt)
                p, lat = rab.lookup(v, requester=i % 8)
            assert p == pt[v]
            got.append((first, (p, lat), _rab_state(rab)))
        assert got[1] == got[0]


@settings(deadline=None)
@given(st.lists(st.integers(0, 40), min_size=1, max_size=100))
def test_resident_subset_of_page_table(vpages):
    ref, port = _rabs()
    pt = {v: v + 100 for v in range(41)}
    for i, v in enumerate(vpages):
        for rab in (ref, port):
            if rab.lookup(v, requester=0)[0] is None:
                rab.handle_misses(pt)
        assert _rab_state(port) == _rab_state(ref)
    for v, p in port.resident().items():
        assert pt[v] == p


def _pool_state(pool) -> dict:
    return {"page_table": dict(pool.page_table), "free": list(pool.free),
            "seq_len": dict(pool.seq_len), "stats": dict(pool.stats)}


@settings(deadline=None)
@given(st.lists(st.sampled_from([("tok", 1), ("tok", 2), ("rel", 1),
                                 ("rel", 2)]), max_size=60))
def test_pool_never_double_maps(ops):
    """No physical page is mapped by two (seq, lpage) keys, free + mapped
    always partitions the pool, and the port's pool raises and holds
    what the reference's does."""
    pools = (JR.PagedKVPool(num_pages=6, page_size=2, max_pages_per_seq=8),
             TR.PagedKVPool(num_pages=6, page_size=2, max_pages_per_seq=8))
    for op, seq in ops:
        raised = []
        for pool in pools:
            try:
                if op == "tok":
                    pool.append_token(seq)
                else:
                    pool.release(seq)
                raised.append(False)
            except MemoryError:
                raised.append(True)
                pool.release(seq)
            mapped = list(pool.page_table.values())
            assert len(mapped) == len(set(mapped))
            assert sorted(mapped + pool.free) == list(range(6))
        assert raised[1] == raised[0]
        assert _pool_state(pools[1]) == _pool_state(pools[0])
