"""pixtral-12b — pixtral-ViT + mistral-nemo backbone [hf:mistralai/Pixtral-12B-2409].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.  The vision frontend
is a STUB per assignment: ``input_specs()`` provides precomputed patch
embeddings of shape (batch, frontend_seq, d_model) merged at the head of the
token sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    frontend="patch",
    frontend_seq=256,   # 16x16 patch grid stub
)
