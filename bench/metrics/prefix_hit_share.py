"""Share of the prompt tokens admitted in the window that the prefix cache
served: hit tokens (the engine's ``prefix_hit`` deltas, which
``cache_stats().prefix_hit_tokens`` counts) over hit tokens plus the
prompt tokens the engine fed in the window (its ``prefill_tokens``
counter)."""


def read(run):
    S = run.log.seconds
    hits = sum(r.hit for r in run.log.records.values()
               if r.hit_t is not None and 0 <= r.hit_t <= S)
    fed = sum(it.prefill_fed for it in run.log.iterations)
    return hits / (hits + fed) if hits + fed else None
