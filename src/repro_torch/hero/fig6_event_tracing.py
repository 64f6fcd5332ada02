"""Fig.6 reproduction: three RAB programs traced and analyzed.

 (a) L1-hit load:   translation completes in a single cycle;
 (b) hit-under-miss: core B's L1 hit completes while core A's L2 search is
                     outstanding (verified by a definable assertion);
 (c) full miss:      core sleeps, handler walks the table, configures an
                     entry, wakes the core.

Events come from the same tracer the serving engine uses; the analyzer's
three layers decode them into the Fig.6-style per-core timeline.  Ported
from ``benchmarks/fig6_event_tracing.py``; it runs on the host only.

    PYTHONPATH=src python -m repro_torch.hero.fig6_event_tracing
"""
from __future__ import annotations

from repro_torch.core.rab import RAB, RABConfig
from repro_torch.core.tracing import TraceBuffer
from repro_torch.core.analysis import (
    Assertion, assert_hit_under_miss, assert_wake_follows_handle,
    layer1_decode, layer2_tlb_transactions, layer3_run, render_timeline,
)


def main():
    tracer = TraceBuffer()
    rab = RAB(RABConfig(l1_entries=2, l2_entries=8, l2_assoc=4, l2_banks=2),
              tracer)
    page_table = {v: 100 + v for v in range(32)}

    # program (a): L1 hit
    rab.lookup(3, requester=0)
    rab.handle_misses(page_table)       # warm
    rab.lookup(3, requester=0)          # single-cycle L1 hit

    # program (b): hit-under-miss — core 1 misses L1 (L2 search), core 2's
    # L1 hit completes independently
    rab.lookup(7, requester=1)
    rab.handle_misses(page_table)
    rab.lookup(8, requester=1)          # evicts, 7 -> L2
    rab.handle_misses(page_table)
    rab.lookup(9, requester=1)
    rab.handle_misses(page_table)
    rab.lookup(7, requester=1)          # L2 hit (multi-cycle search)
    rab.lookup(3, requester=2)          # interleaved L1 hit

    # program (c): full miss -> sleep -> handler walk -> wake -> retry
    rab.lookup(20, requester=4)
    rab.handle_misses(page_table)
    rab.lookup(20, requester=4)

    events = layer1_decode(tracer.drain())
    print("# Fig.6: per-core RAB event timeline")
    print(render_timeline(events))
    print("\n# layer-2 TLB transactions")
    for tx in layer2_tlb_transactions(events):
        print(tx)
    print("\n# layer-3 assertions")
    results = layer3_run(events, [
        Assertion("hit_under_miss", assert_hit_under_miss,
                  "hits complete while another core's miss is outstanding"),
        Assertion("wake_follows_handle", assert_wake_follows_handle,
                  "cores only wake after their miss was handled"),
    ])
    for name, ok in results.items():
        print(f"{name}: {'PASS' if ok else 'FAIL'}")
    print("\n# RAB stats:", rab.stats)
    if not all(results.values()):
        raise RuntimeError(f"Fig.6 assertions failed: {results}")
    return results


if __name__ == "__main__":
    main()
