"""Set-up: the host clock from the process's start to the start of the
traffic (imports, weights made on the device, the kernels' build where
the checkout has none, the pool, the warm-up of both step shapes, shared
prompts served once); a lead-in of traffic before the window is not
set-up."""


def read(run):
    return run.setup_s
