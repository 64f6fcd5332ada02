"""qwen3-32b — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, head_dim=128,
per-head RMSNorm on q and k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
)
