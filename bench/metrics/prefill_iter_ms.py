"""Median host wall of the window's iterations that fed a prompt (the
engine's ``prefill_tokens`` grew), as ``decode_iter_ms`` times them."""
from harness.stats import median


def read(run):
    return median(it.ms for it in run.log.iterations
                  if it.prefill_fed and not it.traced)
