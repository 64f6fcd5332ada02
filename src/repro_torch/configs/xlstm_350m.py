"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks
carry their own up/down projections, there is no separate FFN.  One sLSTM
block per 8 layers (xLSTM[7:1] ratio), rest mLSTM.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    attention_kind="none",
    block_kind="mlstm",
    mlp_kind="none",
    use_rope=False,
    slstm_every=8,
)
