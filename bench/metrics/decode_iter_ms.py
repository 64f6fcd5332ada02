"""Median host wall of the window's decode-only iterations (no prompt
token fed), from the driver's call of ``step()`` to the return of
``poll_deltas()``; ``step()`` ends in the engine's one device-to-host
pull.  Iterations inside the profiled sub-window are left out."""
from harness.stats import median


def read(run):
    return median(it.ms for it in run.log.iterations
                  if not it.prefill_fed and not it.traced)
