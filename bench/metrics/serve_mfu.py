"""Model FLOPs of the tokens computed in the window over the window
times the data sheet's 989 TFLOP/s (dense bf16), in %.  Counted with
``counts``: 2 x active parameters per fed prompt token and per decode
token, attention's 4 * hd * heads * layers per key attended, and the
output head per emitted token.  Prompt tokens the prefix cache served and
padded rows are not counted.  A request's prompt positions computed in
the window run from what it had fed when the window opened (its cache
hit, if it was not yet running) to its end, or, if it is still in
prefill at the close, to what it had fed then."""
from harness.counts import BF16_PEAK_FLOPS, head_flops, span_flops


def read(run):
    g, log = run.geometry, run.log
    S = log.seconds
    flops = 0.0
    for r in log.records.values():
        P = len(r.prompt)
        idx = [k for k, t in enumerate(r.times) if 0 <= t <= S]
        if not (r.times and r.times[0] < 0):
            start = log.fed_at_open.get(r.rid, r.hit)
            end = P if idx and idx[0] == 0 else \
                log.fed_at_close.get(r.rid, start)
            flops += span_flops(g, start, max(start, end))
        if idx:
            a, b = max(idx[0], 1), idx[-1] + 1
            if b > a:
                flops += span_flops(g, P + a - 1, P + b - 1)
            flops += len(idx) * head_flops(g)
    return 100.0 * flops / (S * BF16_PEAK_FLOPS)
