"""minitron-8b — pruned nemotron [arXiv:2407.14679; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.  Nemotron uses
squared-relu MLP; we keep the gated family default (swiglu) for the pruned
variant per the HF config's silu activation... minitron-8b-base uses
relu^2 -> modeled as plain gelu MLP (ungated) to match its 2-matrix FFN.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
    mlp_kind="gelu",  # ungated 2-matrix FFN (nemotron relu^2 family)
)
