"""Share of the rows the device step computed that carried no token.  An
iteration that feeds any prompt runs the whole (lanes, chunk) slab, a
decode-only one (lanes, 1); a row carries a token where it holds a fed
prompt token (the engine's ``prefill_tokens`` counter) or a decode lane's
previous token (a token delta of a request past its first)."""


def read(run):
    computed = carried = 0
    for it in run.log.iterations:
        computed += run.lanes * (run.chunk if it.prefill_fed else 1)
        carried += it.prefill_fed + len(it.decode)
    return (computed - carried) / computed if computed else None
