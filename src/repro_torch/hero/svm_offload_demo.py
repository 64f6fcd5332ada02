"""Offload semantics demo (paper §2.2/Fig.5): the same kernel via
copy-based SM vs zero-copy SVM, with the traced offload protocol.
Ported from ``examples/svm_offload_demo.py``; the kernel is the
cluster matmul (the CUDA kernel on the card, its plain version on the
CPU).

    PYTHONPATH=src python -m repro_torch.hero.svm_offload_demo [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import OffloadTarget, TraceBuffer
from repro_torch.core.analysis import layer1_decode
from repro_torch.device import DeviceLike
from repro_torch.kernels.cluster_matmul import cluster_matmul


def main(device: DeviceLike = None):
    """Run the demo; returns the copy-mode and zero-copy reports, the
    host inputs ``(a, b)`` and the zero-copy output on the device."""
    tgt = OffloadTarget(tracer=TraceBuffer(), device=device)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)

    def kern(a, b):
        return cluster_matmul(a, b)

    out_c, rep_c = tgt.run_copy_based(kern, a, b)
    print(f"copy-based : offload {rep_c.offload_s*1e3:7.2f} ms  "
          f"kernel {rep_c.kernel_s*1e3:7.2f} ms  "
          f"writeback {rep_c.writeback_s*1e3:6.2f} ms  "
          f"({rep_c.bytes_to/2**20:.1f} MiB staged)")

    ha = tgt.svm.share(torch.from_numpy(a).to(tgt.device))
    hb = tgt.svm.share(torch.from_numpy(b).to(tgt.device))
    out_h, rep_z = tgt.run_zero_copy(kern, ha, hb)
    print(f"zero-copy  : offload {rep_z.offload_s*1e3:7.2f} ms  "
          f"kernel {rep_z.kernel_s*1e3:7.2f} ms  (pointer pass only)")
    print(f"total reduction: "
          f"{100*(1 - rep_z.total_s/rep_c.total_s):.1f}%")

    out_z = tgt.svm.deref(out_h)
    np.testing.assert_allclose(out_c, out_z.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    print("results identical across offload modes ✓")
    print(f"{len(layer1_decode(tgt.tracer.drain()))} protocol events traced")
    return rep_c, rep_z, (a, b), out_z


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    main(ap.parse_args().device)
