"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=1024(per expert) vocab=50304,
MoE 64e top-8, qk-norm per the OLMoE config.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=50304,
    head_dim=128,
    use_qk_norm=True,
    moe_num_experts=64,
    moe_top_k=8,
    moe_d_ff=1024,
)
