"""Hardware constants of the card the port runs on (the roofline and the
capacity planner's target).

The port's counterpart of the constants in ``repro.launch.mesh``: the
peak bf16 operation rate and the HBM byte rate of one NVIDIA H100, as
``chip_smoke.py`` phase 15 measures them (a bf16 ``torch.matmul`` at
8192^3 and a device-to-device copy of 1 GiB, 2 GiB moved; medians of
CUDA-event times).  The serving mesh (``make_serving_mesh``) comes with the sharded
engine.
"""
from __future__ import annotations

# Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 15:
# 8192^3 in 1.3762 ms, a 1 GiB copy in 0.7135 ms).  The data sheet's
# dense figures, for comparison: 989e12 FLOP/s (bf16), 3.35e12 bytes/s.
PEAK_FLOPS_BF16 = 7.98961e14   # FLOP/s per card
HBM_BW = 3.00984e12            # bytes/s per card
