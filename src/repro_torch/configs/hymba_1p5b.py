"""hymba-1.5b — parallel attn+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each block runs an attention branch and a Mamba (selective-SSM) branch in
parallel on the same input and mean-fuses their (normed) outputs, followed
by an FFN.  Attention uses sliding window 2048 (hymba uses SWA on most
layers; meta-tokens are omitted — noted in DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    block_kind="hymba",
    sliding_window=2048,
    ssm_state=16,
    ssm_conv_width=4,
    ssm_expand=2,
)
