"""The pool's hypothesis properties on the port's ``core/rab.py``.

The schedule models of ``tests/test_pool_properties.py`` (plain, tiered
and int8-scale-shadowing ``PagedKVPool`` drivers, and the multi-cluster
``ClusterPagedPool`` partition) run here on the port's ``RAB``,
``PagedKVPool`` and ``ClusterPagedPool``: after every operation of every
generated schedule the port's pool keeps the same invariants and holds
exactly the state of the reference's pool driven by the same schedule
(page tables, refcounts, the free list in order, the cached-free LRU,
reservations, prefix index, spilled entries and their ids, pool and RAB
statistics).

Skipped wholesale when hypothesis is not installed, as the reference's
suite is.
"""
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import test_pool_properties as REF  # noqa: E402
from repro.core import rab as JR  # noqa: E402
from repro_torch.core import rab as TR  # noqa: E402

RAB_CFG = dict(l1_entries=4, l2_entries=16, l2_assoc=4, l2_banks=2)


def _state(pool) -> dict:
    """Everything a schedule can change in one pool, in comparable
    form."""
    return dict(
        free=list(pool.free), page_table=dict(pool.page_table),
        seq_len=dict(pool.seq_len), reserved=dict(pool.reserved),
        refcount=dict(pool.refcount), page_key=dict(pool.page_key),
        prefix_index=dict(pool.prefix_index),
        cached_free=list(pool.cached_free), spilled=dict(pool.spilled),
        key_ids=dict(pool.key_ids), next_key_id=pool._next_key_id,
        pending_demote=list(pool.pending_demote),
        pending_spill_drop=list(pool.pending_spill_drop),
        stats=dict(pool.stats),
        rab=None if pool.rab is None else dict(pool.rab.stats),
        resident=None if pool.rab is None else dict(pool.rab.resident()))


def _on_port(model_cls):
    """``model_cls`` from the reference's suite, built on the port's RAB
    and pool."""
    class Port(model_cls):
        def __init__(self):
            super().__init__()
            self.rab = TR.RAB(TR.RABConfig(**RAB_CFG))
            self.pool = TR.PagedKVPool(REF.NUM_PAGES, REF.PAGE_SIZE,
                                       REF.MAX_PAGES_PER_SEQ, self.rab)
            self.pool.spill_enabled = isinstance(self,
                                                 REF.TieredSchedulerModel)
    return Port


def _drive(model_cls, schedule, *, tiers=False, scales=False):
    """Run ``schedule`` on the reference's model and on its port twin;
    after every operation both check their invariants and hold equal
    state (and equal scale shadows)."""
    ref, port = model_cls(), _on_port(model_cls)()
    pair = (ref, port)

    def apply(m, op, arg, max_new, acc):
        if scales:
            m.snapshot()
        if op == "submit":
            m.submit(arg, max_new)
        elif op == "speculate":
            m.speculate(arg, max_new, acc)
        elif op == "fault_swap_in":
            m.fault_swap_in(arg, acc)
        else:
            getattr(m, op)(arg)
        if scales:
            m.reconcile()
        if tiers:
            m.drain_tiers()
        m.check()

    def same():
        assert _state(port.pool) == _state(ref.pool)
        assert port.live == ref.live
        if tiers:
            assert port.store == ref.store
        if scales:
            assert (port.scale, port.store_scale) == \
                (ref.scale, ref.store_scale)

    for step in schedule:
        for m in pair:
            apply(m, *step)
        same()
    for m in pair:
        for s in list(m.live):
            if scales:
                m.snapshot()
            m.pool.release(s)
            if scales:
                m.reconcile()
            if tiers:
                m.drain_tiers()
            m.check()
    same()
    assert port.pool.free_pages() == REF.NUM_PAGES
    assert sum(port.pool.refcount.values()) == 0 == len(port.pool.page_table)


@settings(deadline=None)
@given(REF.SCHEDULE)
def test_pool_invariants_under_random_schedules(schedule):
    """submit / decode / finish / preempt / resume / speculate / cancel /
    fault_swap_in, as the engine drives the pool."""
    _drive(REF.SchedulerModel, schedule)


TIERED = st.lists(st.tuples(REF.TIERED_OPS, st.integers(0, 6),
                            st.integers(1, 4), st.integers(0, 4)),
                  min_size=1, max_size=120)


@settings(deadline=None)
@given(TIERED)
def test_tiered_pool_invariants_under_random_schedules(schedule):
    """The spill-enabled pool: every indexed page in exactly one tier."""
    _drive(REF.TieredSchedulerModel, schedule, tiers=True)


@settings(deadline=None)
@given(TIERED)
def test_quantized_scale_slab_under_random_schedules(schedule):
    """The int8 pool's scale shadow tracks content-holding pages."""
    _drive(REF.QuantizedSchedulerModel, schedule, tiers=True, scales=True)


@settings(deadline=None)
@given(st.lists(st.tuples(st.integers(0, 6), st.integers(1, 3)),
                min_size=1, max_size=40))
def test_prefix_index_consistency(subs):
    """Every prefix-index entry maps a key to a page that holds exactly
    that prefix, on both pools alike."""
    ref, port = REF.SchedulerModel(), _on_port(REF.SchedulerModel)()
    for prompt_idx, max_new in subs:
        for m in (ref, port):
            m.submit(prompt_idx, max_new)
            for k in range(10):
                m.decode(k)
            m.check()
            pool = m.pool
            for key, p in pool.prefix_index.items():
                assert pool.page_key[p] == key
                hit, n = pool.match_prefix(list(key))
                assert n == len(key) and hit[-1] == p
        assert _state(port.pool) == _state(ref.pool)


# ---------------------------------------------------------------------------
# the multi-cluster pool (sharded engine)
# ---------------------------------------------------------------------------

def _cluster_state(cp) -> dict:
    return dict(cluster_of=dict(cp.cluster_of),
                pools=[_state(p) for p in cp.pools],
                occupancy=cp.occupancy(), stats=dict(cp.stats),
                free=cp.free_pages(), available=cp.available())


@settings(deadline=None)
@given(st.integers(1, 4),
       st.lists(st.tuples(REF.CLUSTER_OPS, st.integers(0, 7)),
                min_size=1, max_size=80))
def test_cluster_pool_partition(clusters, schedule):
    """Least-loaded placements and per-sequence page traffic across C
    shards: the port's ``ClusterPagedPool`` keeps the partition
    invariants after every operation and the reference's state."""
    cps = [M.ClusterPagedPool(clusters, REF.NUM_PAGES, REF.PAGE_SIZE,
                              REF.MAX_PAGES_PER_SEQ, M.RABConfig(**RAB_CFG))
           for M in (JR, TR)]
    for cp in cps:
        assert [p.key_id_step for p in cp.pools] == [clusters] * clusters
        assert [p._next_key_id for p in cp.pools] == list(range(clusters))
    live = {}                       # seq -> cluster, shared by both sides
    next_seq = 0
    for op, arg in schedule:
        placed = None
        for cp in cps:
            if op == "submit":
                c = cp.least_loaded()
                pool = cp.pools[c]
                pages = -(-(arg + 1) // REF.PAGE_SIZE)
                if pages > min(pool.available(), REF.MAX_PAGES_PER_SEQ):
                    continue
                cp.place(next_seq, c)
                pool.reserve(next_seq, pages)
                placed = c
            elif op == "append" and live:
                seq = sorted(live)[arg % len(live)]
                pool = cp.pool_for(seq)
                n = pool.seq_len.get(seq, 0)
                need_page = n % REF.PAGE_SIZE == 0
                budget = pool.reserved.get(seq, 0)
                if n // REF.PAGE_SIZE >= REF.MAX_PAGES_PER_SEQ or (
                        need_page and budget == 0 and pool.available() < 1):
                    continue
                pool.append_token(seq)
                pool.drain_cow()
            elif op == "release" and live:
                seq = sorted(live)[arg % len(live)]
                cp.pool_for(seq).release(seq)
                cp.forget(seq)
            cp.check_invariants()
        if placed is not None:
            live[next_seq] = placed
            next_seq += 1
        elif op == "release" and live:
            del live[sorted(live)[arg % len(live)]]
        assert _cluster_state(cps[1]) == _cluster_state(cps[0])
        for c, pool in enumerate(cps[1].pools):
            assert {cps[1].global_page(c, p) for p in pool.free} == \
                {cps[0].global_page(c, p) for p in cps[0].pools[c].free}
    for cp in cps:
        for seq in list(live):
            cp.pool_for(seq).release(seq)
            cp.forget(seq)
            cp.check_invariants()
        assert cp.free_pages() == clusters * REF.NUM_PAGES
        assert not cp.cluster_of
    assert _cluster_state(cps[1]) == _cluster_state(cps[0])


def test_cluster_pool_rejects_double_placement():
    for M in (JR, TR):
        cp = M.ClusterPagedPool(2, REF.NUM_PAGES, REF.PAGE_SIZE,
                                REF.MAX_PAGES_PER_SEQ)
        cp.place(0, 1)
        cp.place(0, 1)                 # idempotent on the same cluster
        with pytest.raises(AssertionError):
            cp.place(0, 0)
        with pytest.raises(AssertionError):
            cp.place(1, 2)
        assert cp.global_page(1, 0) == REF.NUM_PAGES + 1
