"""deepseek-v2-236b — MLA kv_lora=512, 2 shared + 160 routed top-6 [arXiv:2405.04434].

60L d_model=5120 128H d_ff=1536(per expert) vocab=102400.  MLA: kv_lora 512,
q_lora 1536, qk_nope 128, qk_rope 64, v_head 128.  First layer uses a dense
FFN (d_ff 12288); remaining layers are MoE with 2 shared + 160 routed
experts, top-6 routing.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,    # MLA: per-assignment notation; cache is compressed
    d_ff=12288,          # dense-FFN width (layer 0)
    vocab_size=102400,
    attention_kind="mla",
    mla_kv_lora_rank=512,
    mla_q_lora_rank=1536,
    mla_qk_nope_dim=128,
    mla_qk_rope_dim=64,
    mla_v_head_dim=128,
    moe_num_experts=160,
    moe_top_k=6,
    moe_shared_experts=2,
    moe_d_ff=1536,
    moe_first_dense_layers=1,
    remat_policy="full",  # 236B: memory over recompute
)
