"""Device busy ms per decode-only iteration of the MoE layer's kernels:
the kernels launched under the benchmark's spans around
``models/moe.py``'s ``_route``, ``_dispatch``, ``_experts`` and
``_combine``, summed over the profiled decode iterations and divided by
their count."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    steps = [s for s in tr.steps if s.kind == "decode"]
    total = sum(s.moe_ms for s in steps)
    return total / len(steps) if steps and total else None
