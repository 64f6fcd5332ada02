"""gemma2-2b — local+global alternating attention, logit softcaps [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.  Alternating
sliding-window(4096) / global layers, attn softcap 50, final softcap 30,
GeGLU MLP, pre+post RMSNorm, tied embeddings scaled by sqrt(d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    mlp_kind="geglu",
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_period=2,
    post_block_norm=True,
    tie_embeddings=True,
    embedding_scale=True,
)
