"""Share (%) of the bytes bound that the paged-attention kernels reach in
the profiled decode-only iterations: the least time to move each visible
KV token once per layer and KV head at the pool's type, and each lane's
query and output once (``counts.decode_attn_bytes``, from every lane's
context as the driver's records give it), at the data sheet's 3.35 TB/s,
over the profiler's time of the kernels whose names hold ``paged_``."""
from harness.counts import HBM_BYTES_PER_S, decode_attn_bytes


def read(run):
    tr = run.trace
    if tr is None:
        return None
    bound = spent = 0.0
    for s in tr.steps:
        if s.kind == "decode" and s.paged_ms > 0:
            bound += decode_attn_bytes(run.geometry, s.contexts,
                                       run.kv_bytes) / HBM_BYTES_PER_S
            spent += s.paged_ms / 1e3
    return 100.0 * bound / spent if spent else None
