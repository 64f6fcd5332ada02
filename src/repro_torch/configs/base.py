"""Architecture + input-shape configuration system (PyTorch port).

The same frozen dataclasses as ``repro.configs.base``: one ``ArchConfig``
instance per arch in its own module, registered in ``registry.py``.  Only
``param_count`` differs: it sums the port's own parameter shapes
(``repro_torch.models.model.param_shapes``) instead of tracing a JAX spec
tree.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


# ---------------------------------------------------------------------------
# Input shapes (assigned; identical name set for every arch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    """One assigned (seq_len, global_batch) input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # -- attention ----------------------------------------------------------
    head_dim: int = 0                # 0 -> d_model // num_heads
    attention_kind: str = "gqa"      # gqa | mla | none
    use_qk_norm: bool = False
    attn_softcap: float = 0.0        # 0 disables (gemma2: 50.0)
    final_softcap: float = 0.0       # 0 disables (gemma2: 30.0)
    sliding_window: int = 0          # 0 disables
    local_global_period: int = 0     # gemma2: 2 -> alternate [local, global]
    rope_theta: float = 10_000.0
    use_rope: bool = True

    # -- block / mlp --------------------------------------------------------
    block_kind: str = "transformer"  # transformer | mlstm | hymba | encdec
    mlp_kind: str = "swiglu"         # swiglu | geglu | gelu | none
    norm_eps: float = 1e-6
    post_block_norm: bool = False    # gemma2-style post norms
    tie_embeddings: bool = False
    embedding_scale: bool = False    # gemma2 scales embeds by sqrt(d)

    # -- MoE -----------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden
    moe_first_dense_layers: int = 0  # deepseek-v2: 1
    moe_capacity_factor: float = 1.25

    # -- MLA (deepseek-v2) ---------------------------------------------------
    mla_kv_lora_rank: int = 0        # 512
    mla_q_lora_rank: int = 0         # 1536
    mla_qk_nope_dim: int = 128
    mla_qk_rope_dim: int = 64
    mla_v_head_dim: int = 128

    # -- SSM / recurrent -----------------------------------------------------
    ssm_state: int = 0               # mamba state size (hymba: 16)
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0             # xlstm: one sLSTM per this many layers

    # -- enc-dec / frontends -------------------------------------------------
    encoder_layers: int = 0          # whisper: 24
    cross_attention: bool = False
    frontend: str = ""               # "" | "patch" (vlm) | "audio" (whisper)
    frontend_seq: int = 0            # stub-embedding sequence length
    max_positions: int = 0           # learned-position table size (whisper)

    # -- numerics / training -------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    loss_chunk: int = 512            # chunked cross-entropy (vocab-heavy archs)
    remat_policy: str = "full"       # none | dots | full
    scan_layers: bool = True         # kept for config parity with the
                                     # reference; the port unrolls layers

    # ------------------------------------------------------------------ api
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded state?"""
        if self.block_kind == "mlstm":
            return True
        if self.block_kind == "hymba":
            return True  # SWA + SSM
        return False

    @property
    def has_decoder(self) -> bool:
        """Encoder-only archs would return False; none assigned."""
        return True

    def shape_applicable(self, shape: ShapeSpec) -> Tuple[bool, str]:
        """(applicable, reason-if-not) for an assigned shape."""
        if shape.name == "long_500k" and not self.is_subquadratic:
            return False, ("pure full-attention arch: 500k-context decode is "
                           "skipped per assignment (sub-quadratic archs only)")
        if shape.is_decode and not self.has_decoder:
            return False, "encoder-only arch has no decode step"
        return True, ""

    # Per-arch overrides for the serve cache (sliding-window archs bound it).
    def cache_len(self, shape: ShapeSpec) -> int:
        if self.block_kind == "mlstm":
            return 0  # O(1) recurrent state, no KV cache
        if self.block_kind == "hymba":
            return min(self.sliding_window or 2048, shape.seq_len)
        return shape.seq_len

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        n_layers = 2
        if self.slstm_every:
            n_layers = max(2, min(self.slstm_every, 4))
        if self.local_global_period:
            n_layers = 2 * self.local_global_period
        kv = min(self.num_kv_heads, 2)
        heads = max(kv, min(self.num_heads, 4))
        # keep the heads:kv ratio GQA-like when possible
        if heads % kv:
            heads = kv
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            encoder_layers=min(self.encoder_layers, 2),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            moe_num_experts=min(self.moe_num_experts, 4) if self.moe_num_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_shared_experts=min(self.moe_shared_experts, 1),
            moe_d_ff=32 if self.moe_d_ff else 0,
            mla_kv_lora_rank=32 if self.mla_kv_lora_rank else 0,
            mla_q_lora_rank=48 if self.mla_q_lora_rank else 0,
            mla_qk_nope_dim=16 if self.mla_kv_lora_rank else 128,
            mla_qk_rope_dim=8 if self.mla_kv_lora_rank else 64,
            mla_v_head_dim=16 if self.mla_kv_lora_rank else 128,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            frontend_seq=min(self.frontend_seq, 8) if self.frontend_seq else 0,
            max_positions=min(self.max_positions, 64) if self.max_positions else 0,
            loss_chunk=64,
        )


def smoke_shape(kind: str = "train") -> ShapeSpec:
    if kind == "train":
        return ShapeSpec("smoke_train", 32, 4, "train")
    if kind == "prefill":
        return ShapeSpec("smoke_prefill", 32, 2, "prefill")
    return ShapeSpec("smoke_decode", 32, 2, "decode")


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (used for MODEL_FLOPS = 6*N*D), summed over
    the port's own parameter shapes."""
    from repro_torch.models.model import param_shapes  # lazy; avoids cycle
    total = 0
    for shape in param_shapes(cfg).values():
        n = 1
        for s in shape:
            n *= s
        total += n
    return total
