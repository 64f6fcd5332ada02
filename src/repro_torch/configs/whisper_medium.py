"""whisper-medium — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.  24 encoder + 24 decoder
layers (whisper-medium).  The conv/mel frontend is a STUB per assignment:
``input_specs()`` provides precomputed frame embeddings (batch, 1500, d).
GELU MLPs, LayerNorm, no RoPE (learned/sinusoidal positions).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,          # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    block_kind="encdec",
    mlp_kind="gelu",
    use_rope=False,
    cross_attention=True,
    frontend="audio",
    frontend_seq=1500,
    max_positions=32768,
)
