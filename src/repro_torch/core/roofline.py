"""Analytic roofline cost terms: parameters, FLOPs and HBM bytes (ported
from ``repro.core.roofline``; every function returns the reference's
value for the port's configs).

The byte/FLOP models that ``benchmarks/roofline.py`` renders into its
roofline table, factored into an importable library so the capacity
planner (``repro_torch.planner``) can price engine iterations from the same
first principles the benchmark reports — one cost model, two consumers.

Everything here is a pure function of an :class:`~repro_torch.configs.
base.ArchConfig` (plus a shape or serving knobs): no artifacts, no I/O, no
clock.  Hardware peaks live in ``repro_torch.launch.mesh``
(``PEAK_FLOPS_BF16`` / ``HBM_BW``, measured on an H100).

Two byte models coexist on purpose:

* :func:`cache_bytes` — the *roofline* decode-cache model, per
  architecture family (paged KV, MLA latent, SSM state, sliding
  windows), with the paged-KV terms rescaled by ``kv_dtype``.  It uses
  the :data:`KV_PAGE_SIZE` default page size to amortize the int8 scale
  slab, matching the benchmark's historical output.
* :func:`kv_bytes_per_token` — the *engine's own* per-token KV
  footprint for an explicit ``page_size``, byte-identical to
  ``engine.cache_stats().bytes_per_token`` — this is the term the
  planner uses when pricing a concrete ``EngineConfig``.
"""
from __future__ import annotations

from typing import Dict

__all__ = [
    "KV_PAGE_SIZE", "param_counts", "model_flops", "analytic_bytes",
    "kv_elt_bytes", "cache_bytes", "kv_bytes_per_token",
]


def param_counts(cfg) -> Dict[str, float]:
    """total N and active N (MoE: routed experts scaled by top_k/E), over
    the port's parameter shapes (``models.model.param_shapes``)."""
    from repro_torch.models.model import param_shapes
    total = active = 0.0
    for path, shape in param_shapes(cfg).items():
        n = 1
        for d in shape:
            n *= d
        total += n
        if "/moe/w_" in path:
            active += n * cfg.moe_top_k / max(cfg.moe_num_experts, 1)
        else:
            active += n
    return {"total": total, "active": active}


def model_flops(cfg, shape) -> float:
    """Global MODEL_FLOPS per step (6*N_active*D train, 2*N_active*D fwd)."""
    n = param_counts(cfg)["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token / request


def analytic_bytes(cfg, shape, devices: int,
                   kv_dtype: str = "bf16") -> float:
    """Per-device HBM bytes per step (analytic lower-bound model)."""
    n_total = param_counts(cfg)["total"]
    bp = 2.0                                      # bf16 params
    if shape.kind == "train":
        # fwd read + bwd read (remat re-read) + grad write + adam m/v rw +
        # param write; all param-state is fully sharded (FSDP x TP)
        w = n_total * (bp * 3 + 4 * 4 + bp) / devices
        # activations: residual saves + recompute IO, 2 bytes, seq-sharded
        act = (cfg.num_layers + (cfg.encoder_layers or 0)) * \
            shape.global_batch * shape.seq_len * cfg.d_model * 2 * 4 / devices
        return w + act
    if shape.kind == "prefill":
        w = n_total * bp / devices
        act = (cfg.num_layers + (cfg.encoder_layers or 0)) * \
            shape.global_batch * shape.seq_len * cfg.d_model * 2 * 2 / devices
        return w + act
    # decode: weights once + full KV/state cache read + small writes
    w = n_total * bp / devices
    cache = cache_bytes(cfg, shape, kv_dtype) / devices
    return w + cache


#: CacheConfig.page_size default — amortizes the per-page scale slab
KV_PAGE_SIZE = 8


def kv_elt_bytes(kv_dtype: str, hd: int, page_size: int = KV_PAGE_SIZE
                 ) -> float:
    """Bytes per paged-KV element: int8 pages carry one f32 scale per
    (page, K/V, head), i.e. 4 bytes amortized over hd * page_size
    elements; bf16 pages are exact two-byte elements."""
    if kv_dtype == "int8":
        return 1.0 + 4.0 / (hd * page_size)
    return 2.0


def cache_bytes(cfg, shape, kv_dtype: str = "bf16") -> float:
    """Global decode-cache bytes (read once per decoded token).

    ``kv_dtype`` rescales only the paged attention KV terms — MLA's
    latent cache, SSM and mLSTM recurrent state are not paged int8."""
    B, T = shape.global_batch, cfg.cache_len(shape)
    hd = cfg.resolved_head_dim
    kvb = kv_elt_bytes(kv_dtype, hd)
    if cfg.block_kind == "mlstm":
        H = cfg.num_heads
        return cfg.num_layers * B * H * (hd * hd + hd + 1) * 4.0
    if cfg.attention_kind == "mla":
        return cfg.num_layers * B * T * (cfg.mla_kv_lora_rank +
                                         cfg.mla_qk_rope_dim) * 2.0
    if cfg.block_kind == "hymba":
        raise NotImplementedError(
            f"{cfg.name}: the SSM/hybrid state model comes with the port's "
            "SSM layers")
    if cfg.block_kind == "encdec":
        self_c = cfg.num_layers * B * T * cfg.num_kv_heads * hd * 2 * kvb
        cross = cfg.num_layers * B * cfg.frontend_seq * cfg.num_kv_heads * hd * 2 * kvb
        return self_c + cross
    if cfg.local_global_period:
        n_local = (cfg.num_layers + 1) // cfg.local_global_period
        n_global = cfg.num_layers - n_local
        W = min(cfg.sliding_window, T)
        return (n_local * W + n_global * T) * B * cfg.num_kv_heads * hd * 2 * kvb
    return cfg.num_layers * B * T * cfg.num_kv_heads * hd * 2 * kvb


def kv_bytes_per_token(cfg, kv_dtype: str = "bf16",
                       page_size: int = KV_PAGE_SIZE) -> float:
    """KV-cache bytes of ONE resident token across all layers, for an
    explicit engine ``page_size`` — the exact formula
    ``engine.cache_stats()`` publishes as ``bytes_per_token``.

    int8 pages add one float32 scale per (page, K/V, kv-head): 2 slots *
    4 bytes * num_kv_heads amortized over ``page_size`` tokens."""
    hd = cfg.resolved_head_dim
    kv_hd = cfg.num_kv_heads * hd
    if kv_dtype == "int8":
        return cfg.num_layers * 2.0 * (kv_hd + 4.0 * cfg.num_kv_heads
                                       / page_size)
    itemsize = 4.0 if "32" in str(cfg.param_dtype) else 2.0
    return cfg.num_layers * 2.0 * kv_hd * itemsize
