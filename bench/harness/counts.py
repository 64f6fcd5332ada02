"""Frozen operation and byte counts, and the data sheet's peaks.

These are the yardstick of the serving metrics: they count the work a
token needs from the model's sizes alone, so a metric built on them reads
the same work whatever implements it.  Peaks are NVIDIA's data sheet for
one H100 SXM (dense, no sparsity, at the full 700 W power limit).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

#: H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Geometry:
    layers: int
    d: int
    heads: int
    kv_heads: int
    hd: int
    vocab: int
    ff: int = 0             # dense SwiGLU width
    experts: int = 0
    top_k: int = 0
    expert_ff: int = 0

    @classmethod
    def of(cls, conf: dict) -> "Geometry":
        """From a configuration file's published keys."""
        d, H = conf["hidden_size"], conf["num_attention_heads"]
        experts = conf.get("num_experts", 0)
        return cls(layers=conf["num_hidden_layers"], d=d, heads=H,
                   kv_heads=conf["num_key_value_heads"],
                   hd=conf.get("head_dim") or d // H,
                   vocab=conf["vocab_size"],
                   ff=0 if experts else conf["intermediate_size"],
                   experts=experts,
                   top_k=conf.get("num_experts_per_tok", 0),
                   expert_ff=conf["intermediate_size"] if experts else 0)


def active_params(g: Geometry) -> int:
    """Matmul parameters one token passes through, outside the embedding
    and the output head: attention's four projections and the FFN (the
    router and ``top_k`` experts' SwiGLU for an MoE layer)."""
    attn = g.d * g.hd * (2 * g.heads + 2 * g.kv_heads)
    ffn = 3 * g.d * g.ff if not g.experts else \
        g.d * g.experts + g.top_k * 3 * g.d * g.expert_ff
    return g.layers * (attn + ffn)


def attn_flops_per_key(g: Geometry) -> int:
    """QK^T and PV: 2 * hd each per (query, key) pair, per head and
    layer."""
    return 4 * g.hd * g.heads * g.layers


def span_flops(g: Geometry, start: int, stop: int) -> float:
    """Model FLOPs of computing positions ``start .. stop - 1`` of one
    sequence (each attends to itself and every earlier position), without
    the output head."""
    n = stop - start
    keys = (stop * (stop + 1) - start * (start + 1)) // 2
    return 2.0 * active_params(g) * n + float(attn_flops_per_key(g)) * keys


def head_flops(g: Geometry) -> float:
    """The output head of one sampled row."""
    return 2.0 * g.d * g.vocab


def decode_attn_bytes(g: Geometry, contexts: Iterable[int],
                      kv_bytes: int = 2, q_bytes: int = 2) -> float:
    """Bytes the paged-attention kernels of one decode iteration must move
    at least: each visible KV token read once per layer and KV head (K and
    V), each lane's query read once and its output written once."""
    ctx = list(contexts)
    kv = sum(ctx) * g.layers * g.kv_heads * g.hd * 2 * kv_bytes
    q_out = len(ctx) * g.layers * g.heads * g.hd * 2 * q_bytes
    return float(kv + q_out)
