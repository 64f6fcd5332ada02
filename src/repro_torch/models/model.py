"""Model assembly as an ``nn.Module``, with the reference's layout: its
full-sequence forward and loss (the training path) and its one-token
decode forward over per-family caches (``init_cache``,
``decode_forward``, ``prefill_logits``).

Parameters keep ``repro.models.model``'s names and shapes, per layer
instead of stacked.  A GQA transformer layer (``layers/i``) holds
``attn.wq (d,H,hd)``, ``attn.wk/wv (d,Kv,hd)``, ``attn.wo (H,hd,d)``,
``mlp.w_gate/w_up (d,ff)``, ``mlp.w_down (ff,d)``, gemma2's post-block
norms ``pln1``/``pln2`` and the norms' ``scale`` (always float32); a
routed-expert (MoE) layer holds ``moe.router (d,E)`` (always float32),
``moe.w_gate/w_up (E,d,f)`` and ``moe.w_down (E,f,d)`` in place of
``mlp``, and with shared experts ``moe.shared.{w_gate,w_up,w_down}``.
An MLA layer's ``attn`` (deepseek-v2) holds ``w_dq (d,r_q)``, ``q_norm
(r_q,)``, ``w_uq (r_q,H,nope+rope)``, ``w_dkv (d,r_kv+rope)``, ``kv_norm
(r_kv,)``, ``w_uk (r_kv,H,nope)``, ``w_uv (r_kv,H,v)`` and ``wo
(H,v,d)``; an MoE model with ``moe_first_dense_layers`` puts that many
dense layers in a ``first_layers`` stack before ``layers``.
A hymba layer (``layers/i``) holds ``ln1``, ``attn``, ``mamba`` (the
Mamba branch, ``models.ssm``), ``bn_attn``, ``bn_ssm``, ``ln2`` and
``mlp``; xlstm holds two stacks, ``mlstm_layers/j/{ln1,cell}`` and
``slstm_layers/j/{ln1,cell}``; whisper's encoder-decoder holds
``enc_layers/j/{ln1,attn,ln2,mlp}``, ``enc_norm``, ``enc_pos (F,d)``,
``dec_layers/i/{ln1,attn,lnx,xattn,ln2,mlp}`` (``xattn`` laid out as
``attn``) and ``dec_pos (max_positions,d)``, every norm of it a
LayerNorm with a float32 ``bias`` beside its ``scale``.  Beside them
``embed.table/head (V,d)`` (no ``head`` with tied embeddings) and
``final_norm``.  Every container
is an ``nn.ParameterDict`` / ``nn.ModuleDict``, so the layer functions
index it exactly as the reference indexes its pytree
(``lp["attn"]["wq"]``).  The serving forward lives with the engine
(``runtime.server._paged_forward``), as in the reference; the paged
server refuses what it does not serve (:func:`_check_supported`).

Two ways to fill it:

* :func:`init_params` — ``normal / sqrt(fan_in)`` draws (the reference's
  ``ParamFactory`` rule, its constant inits kept) from an explicit
  ``torch.Generator``;
* :func:`params_from_jax` — carry the reference's ``init_params`` output
  (a pytree of numpy arrays, layers stacked as ``(L, ...)`` leaves) into
  the port, so both sides compute on identical weights.

:func:`forward_fullseq` and :func:`loss_fn` are the training path's
forward for the dense, MoE and local/global (gemma2) transformer stacks,
hymba, xlstm, a patch frontend's (pixtral), the encoder-decoder
(whisper) and MLA behind dense first layers (deepseek-v2), with
per-layer activation checkpointing under
``cfg.remat_policy``.  :func:`decode_forward` is one token against a
dense cache from :func:`init_cache`: per-layer tensors, updated in place;
whisper's cross-attention cache comes from one :func:`encdec_cross_cache`.

:func:`param_axes` and :func:`cache_axes` give every leaf its logical
axes (the reference's ``ParamFactory`` annotations, per layer), and the
forward carries the reference's ``shard`` constraints; they act only
under a mesh (``parallel.sharding``, ``steps.lowerable``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.parallel.sharding import Axes, shard

# "slot not written" marker for position caches.  Must be a large POSITIVE
# value: masks keep slots with kpos <= current position, so an empty slot
# must compare greater than any real position.
EMPTY_POS = 2 ** 30

#: the layer stacks a parameter path can start with
STACKS = ("first_layers", "layers", "mlstm_layers", "slstm_layers",
          "enc_layers", "dec_layers")
#: leaves kept in float32 whatever ``param_dtype`` is, beside the norms
#: and the MoE router (the reference's ``dtype=jnp.float32`` leaves;
#: ``bias`` is a LayerNorm's)
_F32_LEAVES = ("w_if", "b_if", "head_norm", "b_dt", "log_A", "D", "bias")
#: leaves the reference initialises to a constant
_ONES = ("head_norm", "b_dt", "D")
_ZEROS = ("conv_b", "log_A", "b_if", "bias")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _n_first(cfg: ArchConfig) -> int:
    """Dense layers before the MoE stack (the reference's
    ``moe_first_dense_layers``, read only where there are experts)."""
    return cfg.moe_first_dense_layers if cfg.moe_num_experts else 0


def _check_params_supported(cfg: ArchConfig):
    """The parameter layouts ported: transformers with GQA or MLA
    attention, dense or with routed (and shared) experts, with or without
    dense first layers, gemma2's local/global layers and post-block norms,
    and a patch frontend (pixtral: no leaves of its own); hymba; xlstm;
    the GQA encoder-decoder (whisper).  MLA elsewhere raises."""
    if cfg.block_kind == "mlstm":
        return
    if not (cfg.attention_kind == "gqa" and cfg.block_kind in (
            "transformer", "hymba", "encdec")
            or cfg.attention_kind == "mla"
            and cfg.block_kind == "transformer"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.attention_kind} attention in a "
            f"{cfg.block_kind} stack is not ported")


def _check_supported(cfg: ArchConfig):
    """The paged server's guard: plain GQA decoders only, dense or MoE (no
    local/global layers, which the reference's server refuses too, and
    no post-block norms, which its paged forward does not apply).  A
    patch frontend's model (pixtral) is served as its text decoder: the
    engine takes tokens, as the reference's does.  MLA raises, as the
    reference's server asserts GQA; so do dense first layers, which the
    reference's paged forward would skip (it walks ``layers`` for every
    layer index, and a static index past the stack is clamped)."""
    _check_params_supported(cfg)
    if cfg.attention_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: the paged server serves GQA attention only, "
            f"not {cfg.attention_kind}")
    if _n_first(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the paged server does not serve dense first "
            "layers before the MoE stack")
    if cfg.block_kind != "transformer" or cfg.local_global_period \
            or cfg.post_block_norm:
        raise NotImplementedError(
            f"{cfg.name}: the paged server serves plain GQA decoders only")


def _n_slstm(cfg: ArchConfig) -> int:
    """xlstm's sLSTM layers: one heads each group of ``slstm_every``."""
    return -(-cfg.num_layers // cfg.slstm_every) if cfg.slstm_every else 0


def _stacks(cfg: ArchConfig) -> Dict[str, int]:
    """Layer stack -> its layer count, in the reference's build order."""
    if cfg.block_kind == "encdec":
        return {"enc_layers": cfg.encoder_layers,
                "dec_layers": cfg.num_layers}
    if cfg.block_kind != "mlstm":
        n_first = _n_first(cfg)
        if n_first:
            return {"first_layers": n_first,
                    "layers": cfg.num_layers - n_first}
        return {"layers": cfg.num_layers}
    n_s = _n_slstm(cfg)
    out = {"mlstm_layers": cfg.num_layers - n_s}
    if n_s:
        out["slstm_layers"] = n_s
    return out


def _mlp_shapes(cfg: ArchConfig, group: str, ff: int
                ) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    out = {}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        out[f"{group}/w_gate"] = (d, ff)
    out[f"{group}/w_up"] = (d, ff)
    out[f"{group}/w_down"] = (ff, d)
    return out


def _gqa_shapes(cfg: ArchConfig, group: str = "attn"
                ) -> Dict[str, Tuple[int, ...]]:
    d, H, K = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    out = {f"{group}/wq": (d, H, hd), f"{group}/wk": (d, K, hd),
           f"{group}/wv": (d, K, hd), f"{group}/wo": (H, hd, d)}
    if cfg.use_qk_norm:
        out[f"{group}/q_norm"] = (hd,)
        out[f"{group}/k_norm"] = (hd,)
    return out


def _mla_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d, H = cfg.d_model, cfg.num_heads
    r_kv, r_q = cfg.mla_kv_lora_rank, cfg.mla_q_lora_rank
    dn, dr, dv = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim, \
        cfg.mla_v_head_dim
    shapes = {"w_dq": (d, r_q), "q_norm": (r_q,), "w_uq": (r_q, H, dn + dr),
              "w_dkv": (d, r_kv + dr), "kv_norm": (r_kv,),
              "w_uk": (r_kv, H, dn), "w_uv": (r_kv, H, dv),
              "wo": (H, dv, d)}
    return {f"attn/{k}": s for k, s in shapes.items()}


def _norm_shapes(cfg: ArchConfig, name: str) -> Dict[str, Tuple[int, ...]]:
    """A norm's ``scale``, and a LayerNorm's ``bias`` (the reference gives
    one to every norm of a GELU encoder-decoder: whisper's)."""
    d = cfg.d_model
    out = {f"{name}/scale": (d,)}
    if cfg.norm_eps and cfg.mlp_kind == "gelu" \
            and cfg.block_kind == "encdec":
        out[f"{name}/bias"] = (d,)
    return out


def _mamba_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    di, dtr, N = S.mamba_dims(cfg)
    shapes = {"w_in": (d, 2 * di), "conv_w": (cfg.ssm_conv_width, di),
              "conv_b": (di,), "w_dt_down": (di, dtr),
              "w_dt_up": (dtr, di), "b_dt": (di,), "w_B": (di, N),
              "w_C": (di, N), "log_A": (di, N), "D": (di,),
              "w_out": (di, d)}
    return {f"mamba/{k}": s for k, s in shapes.items()}


def _cell_shapes(cfg: ArchConfig, stack: str) -> Dict[str, Tuple[int, ...]]:
    """An xlstm layer: ``ln1`` and its mLSTM or sLSTM ``cell``."""
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    if stack == "mlstm_layers":
        cell = {"wq": (d, H, hd), "wk": (d, H, hd), "wv": (d, H, hd),
                "w_if": (d, 2 * H), "b_if": (2 * H,), "w_og": (d, d),
                "head_norm": (H, hd), "w_out": (d, d)}
    else:
        cell = {"w_in": (d, 4, H, hd), "r": (4, H, hd, hd),
                "b": (4, H, hd), "head_norm": (H, hd), "w_out": (d, d)}
    return {"ln1/scale": (d,), **{f"cell/{k}": s for k, s in cell.items()}}


def _layer_shapes(cfg: ArchConfig, stack: str = "layers"
                  ) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    if stack == "enc_layers":
        return {**_norm_shapes(cfg, "ln1"), **_gqa_shapes(cfg),
                **_norm_shapes(cfg, "ln2"), **_mlp_shapes(cfg, "mlp",
                                                          cfg.d_ff)}
    if stack == "dec_layers":
        return {**_norm_shapes(cfg, "ln1"), **_gqa_shapes(cfg),
                **_norm_shapes(cfg, "lnx"), **_gqa_shapes(cfg, "xattn"),
                **_norm_shapes(cfg, "ln2"), **_mlp_shapes(cfg, "mlp",
                                                          cfg.d_ff)}
    if stack not in ("layers", "first_layers"):
        return _cell_shapes(cfg, stack)
    if cfg.block_kind == "hymba":
        return {"ln1/scale": (d,), **_gqa_shapes(cfg), **_mamba_shapes(cfg),
                "bn_attn/scale": (d,), "bn_ssm/scale": (d,),
                "ln2/scale": (d,), **_mlp_shapes(cfg, "mlp", cfg.d_ff)}
    attn = _mla_shapes(cfg) if cfg.attention_kind == "mla" \
        else _gqa_shapes(cfg)
    out = {"ln1/scale": (d,), **attn, "ln2/scale": (d,)}
    if cfg.moe_num_experts and stack == "layers":
        E, f = cfg.moe_num_experts, cfg.moe_d_ff
        out["moe/router"] = (d, E)
        out["moe/w_gate"] = (E, d, f)
        out["moe/w_up"] = (E, d, f)
        out["moe/w_down"] = (E, f, d)
        if cfg.moe_shared_experts:
            out.update(_mlp_shapes(cfg, "moe/shared",
                                   f * cfg.moe_shared_experts))
    else:
        out.update(_mlp_shapes(cfg, "mlp", cfg.d_ff))
    if cfg.post_block_norm:
        out["pln1/scale"] = (d,)
        out["pln2/scale"] = (d,)
    return out


def _top_shapes(cfg: ArchConfig, stack: str) -> Dict[str, Tuple[int, ...]]:
    """The leaves outside the layer stacks the reference builds right
    after ``stack``: whisper's ``enc_norm`` and ``enc_pos`` after the
    encoder, ``dec_pos`` after the decoder."""
    if stack == "enc_layers":
        return {**_norm_shapes(cfg, "enc_norm"),
                "enc_pos": (cfg.frontend_seq, cfg.d_model)}
    if stack == "dec_layers":
        return {"dec_pos": (cfg.max_positions, cfg.d_model)}
    return {}


def param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's path -> shape, in init order."""
    _check_params_supported(cfg)
    V, d = cfg.vocab_size, cfg.d_model
    out: Dict[str, Tuple[int, ...]] = {"embed/table": (V, d)}
    if not cfg.tie_embeddings:
        out["embed/head"] = (V, d)
    for stack, n in _stacks(cfg).items():
        shapes = _layer_shapes(cfg, stack)
        for i in range(n):
            for k, s in shapes.items():
                out[f"{stack}/{i}/{k}"] = s
        out.update(_top_shapes(cfg, stack))
    out.update(_norm_shapes(cfg, "final_norm"))
    return out


#: logical axes of a leaf, by its group and name (the reference's
#: ``ParamFactory`` calls); a norm's ``scale`` / ``bias`` and every leaf
#: not named here are replicated
_GQA_AXES = {"wq": ("fsdp", "tp", None), "wk": ("fsdp", "tp", None),
             "wv": ("fsdp", "tp", None), "wo": ("tp", None, "fsdp")}
_MLA_AXES = {"w_dq": ("fsdp", None), "w_uq": (None, "tp", None),
             "w_dkv": ("fsdp", None), "w_uk": (None, "tp", None),
             "w_uv": (None, "tp", None), "wo": ("tp", None, "fsdp")}
_MLP_AXES = {"w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
             "w_down": ("tp", "fsdp")}
_MOE_AXES = {"router": (None, None), "w_gate": ("ep", "fsdp", None),
             "w_up": ("ep", "fsdp", None), "w_down": ("ep", None, "fsdp")}
_MAMBA_AXES = {"w_in": ("fsdp", "tp"), "conv_w": (None, "tp"),
               "conv_b": ("tp",), "w_dt_down": ("tp", None),
               "w_dt_up": (None, "tp"), "b_dt": ("tp",),
               "w_B": ("tp", None), "w_C": ("tp", None),
               "log_A": ("tp", None), "D": ("tp",),
               "w_out": ("tp", "fsdp")}
_MLSTM_AXES = {"wq": ("fsdp", "tp", None), "wk": ("fsdp", "tp", None),
               "wv": ("fsdp", "tp", None), "w_if": ("fsdp", None),
               "w_og": ("fsdp", "tp"), "head_norm": ("tp", None),
               "w_out": ("tp", "fsdp")}
_SLSTM_AXES = {"w_in": ("fsdp", None, "tp", None),
               "r": (None, "tp", None, None), "b": (None, "tp", None),
               "head_norm": ("tp", None), "w_out": ("tp", "fsdp")}


def _leaf_axes(cfg: ArchConfig, path: str, ndim: int
               ) -> Tuple[Optional[str], ...]:
    """The logical axes of the leaf at ``path`` (no stack dim: the port's
    leaves are per layer)."""
    parts = path.split("/")
    if parts[0] in STACKS:
        stack, parts = parts[0], parts[2:]
    else:
        stack = None
    leaf, group = parts[-1], parts[:-1]
    table: Mapping[str, Tuple[Optional[str], ...]] = {}
    if group == ["embed"]:
        table = {"table": ("tp", "fsdp"), "head": ("tp", "fsdp")}
    elif not group and leaf in ("enc_pos", "dec_pos"):
        table = {leaf: (None, "fsdp")}
    elif group and group[0] in ("attn", "xattn"):
        table = _MLA_AXES if cfg.attention_kind == "mla" \
            and group[0] == "attn" else _GQA_AXES
    elif group in (["mlp"], ["moe", "shared"]):
        table = _MLP_AXES
    elif group == ["moe"]:
        table = _MOE_AXES
    elif group == ["mamba"]:
        table = _MAMBA_AXES
    elif group == ["cell"]:
        table = _MLSTM_AXES if stack == "mlstm_layers" else _SLSTM_AXES
    return table.get(leaf, (None,) * ndim)


def param_specs(cfg: ArchConfig) -> Dict[str, Tuple]:
    """Every :func:`param_shapes` path -> (shape, dtype)."""
    dt = _dtype(cfg)
    return {path: (s, torch.float32 if _is_f32(path) else dt)
            for path, s in param_shapes(cfg).items()}


def param_axes(cfg: ArchConfig) -> Dict[str, Axes]:
    """Every :func:`param_shapes` path -> its logical :class:`Axes`."""
    return {path: Axes(_leaf_axes(cfg, path, len(shape)))
            for path, shape in param_shapes(cfg).items()}


def _fan_in(cfg: ArchConfig, path: str, shape: Tuple[int, ...]) -> int:
    """The reference ParamFactory's fan-in: the first dim unless the
    reference's parameter definition names another (``wo (H, hd, d)``:
    H*hd, MLA's ``(H, v, d)``: H*v, a dense ``w_down``: its ff, an expert
    ``w_down``: ``moe_d_ff``, sLSTM's ``r``: hd, embeddings: d; Mamba's
    ``w_dt_up`` (dtr) and ``w_out`` (di) and MLA's ``w_uq`` (r_q) and
    ``w_uk``/``w_uv`` (r_kv) name their first dim).  So the experts'
    ``w_gate``/``w_up`` (E, d, f) draw with fan-in E, as the reference's
    do."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "wo":
        return shape[0] * shape[1]
    if leaf == "w_down":
        return shape[-2]
    if leaf == "r":
        return cfg.resolved_head_dim
    if path.startswith("embed/"):
        return cfg.d_model
    return shape[0]


def _is_norm(path: str) -> bool:
    leaf = path.rsplit("/", 1)[-1]
    return leaf in ("q_norm", "k_norm", "kv_norm") or \
        path.endswith("scale")


def _is_slstm_bias(path: str) -> bool:
    return path.startswith("slstm_layers/") and path.endswith("cell/b")


def _is_f32(path: str) -> bool:
    """Leaves kept in float32 whatever ``param_dtype`` is: the norms, the
    MoE router, mLSTM's gate projection and bias and head norm, sLSTM's
    bias and head norm, Mamba's ``b_dt``, ``log_A`` and ``D``."""
    return (_is_norm(path) or path.endswith("moe/router")
            or path.rsplit("/", 1)[-1] in _F32_LEAVES
            or _is_slstm_bias(path))


def _const_init(path: str) -> Optional[float]:
    """The constant a leaf starts at (the reference's ``init="ones"`` /
    ``"zeros"``), None for a random draw."""
    leaf = path.rsplit("/", 1)[-1]
    if _is_norm(path) or leaf in _ONES:
        return 1.0
    if leaf in _ZEROS or _is_slstm_bias(path):
        return 0.0
    return None


def _param(path: str, shape: Tuple[int, ...], dtype, device
           ) -> nn.Parameter:
    return nn.Parameter(torch.empty(
        shape, dtype=torch.float32 if _is_f32(path) else dtype,
        device=device), requires_grad=False)


def _pdict(shapes: Mapping[str, Tuple[int, ...]], dtype, device,
           prefix: str = ""):
    """A (nested) ``ParameterDict`` of ``shapes`` (relative path ->
    shape): a path ``a/b`` becomes ``d["a"]["b"]``."""
    out = nn.ParameterDict()
    sub: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    for k, s in shapes.items():
        head, _, rest = k.partition("/")
        if rest:
            sub.setdefault(head, {})[rest] = s
            continue
        out[k] = _param(prefix + k, s, dtype, device)
    for head, shp in sub.items():
        out[head] = _pdict(shp, dtype, device, f"{prefix}{head}/")
    return out


class DenseDecoder(nn.Module):
    """A model's weights: ``embed``, its layer stacks (``layers[i]``,
    after ``first_layers[j]`` where there are dense first layers, or
    xlstm's ``mlstm_layers[j]`` and ``slstm_layers[j]``, or whisper's
    ``enc_layers[j]`` and ``dec_layers[i]`` with ``enc_norm``,
    ``enc_pos`` and ``dec_pos`` after them) and ``final_norm``.  Every
    parameter starts with ``requires_grad=False`` (serving); the training
    path's ``steps.init_train_state`` switches it on."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        _check_params_supported(cfg)
        self.cfg = cfg
        dtype = _dtype(cfg)
        V, d = cfg.vocab_size, cfg.d_model
        emb = {"embed/table": (V, d)}
        if not cfg.tie_embeddings:
            emb["embed/head"] = (V, d)
        self._add_top(emb, dtype, device)
        for stack, n in _stacks(cfg).items():
            groups: Dict[str, Dict[str, Tuple[int, ...]]] = {}
            for path, s in _layer_shapes(cfg, stack).items():
                g, rest = path.split("/", 1)
                groups.setdefault(g, {})[rest] = s
            setattr(self, stack, nn.ModuleList([
                nn.ModuleDict({g: _pdict(ls, dtype, device,
                                         f"{stack}/{g}/")
                               for g, ls in groups.items()})
                for _ in range(n)]))
            self._add_top(_top_shapes(cfg, stack), dtype, device)
        self._add_top(_norm_shapes(cfg, "final_norm"), dtype, device)

    def _add_top(self, shapes: Mapping[str, Tuple[int, ...]], dtype,
                 device):
        """Leaves outside the layer stacks: ``a/b`` paths become a
        ``ParameterDict`` attribute ``a``, a bare ``a`` a parameter."""
        groups: Dict[str, Dict[str, Tuple[int, ...]]] = {}
        for path, s in shapes.items():
            g, _, rest = path.partition("/")
            if rest:
                groups.setdefault(g, {})[rest] = s
            else:
                setattr(self, g, _param(g, s, dtype, device))
        for g, ls in groups.items():
            setattr(self, g, _pdict(ls, dtype, device, f"{g}/"))

    def param(self, path: str) -> torch.Tensor:
        """The parameter at a ``param_shapes`` path."""
        parts = path.split("/")
        if parts[0] in STACKS:
            node = getattr(self, parts[0])[int(parts[1])]
            parts = parts[2:]
        else:
            node = getattr(self, parts.pop(0))
        for part in parts:
            node = node[part]
        return node

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device


def set_param(model: DenseDecoder, path: str, t: torch.Tensor):
    """Make ``t`` the parameter at a ``param_shapes`` path."""
    head, _, leaf = path.rpartition("/")
    parent = model.param(head) if head else model
    p = nn.Parameter(t, requires_grad=False)
    if isinstance(parent, nn.ParameterDict):
        parent[leaf] = p
    else:
        setattr(parent, leaf, p)


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0,
                device: DeviceLike = None) -> DenseDecoder:
    """Random weights from ``seed``: the reference's constant leaves
    (norms, ``head_norm``, ``b_dt``, ``D``: ones; ``conv_b``, ``log_A``,
    the gate biases: zeros), every other leaf ``normal / sqrt(fan_in)``
    drawn in float32 then cast to its type.  The draws come from a
    ``torch.Generator`` on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``), so the same seed gives the same weights on the same device
    type, not across device types."""
    dev = resolve_device(device)
    model = DenseDecoder(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for path, shape in param_shapes(cfg).items():
        p = model.param(path)
        const = _const_init(path)
        if const is not None:
            p.fill_(const)
            continue
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        p.copy_(w * (1.0 / math.sqrt(max(_fan_in(cfg, path, shape), 1))))
    return model


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """numpy -> torch, including the reference's ml_dtypes bfloat16."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _reference_path(path: str) -> Tuple[List[str], Optional[int]]:
    """A ``param_shapes`` path as the reference tree's keys, and the layer
    index into the stacked leaf (None outside the layer stacks):
    ``layers/3/moe/shared/w_up`` -> (``[layers, moe, shared, w_up]``, 3)."""
    parts = path.split("/")
    if parts[0] in STACKS:
        return [parts[0]] + parts[2:], int(parts[1])
    return parts, None


def reference_leaf(tree, path: str):
    """What a tree in the reference's layout (layers stacked as ``(L,
    ...)`` leaves) holds for the port's parameter ``path``: layer i's
    slice of the stacked leaf for ``<stack>/i/...``."""
    keys, layer = _reference_path(path)
    for key in keys:
        tree = tree[key]
    return tree if layer is None else tree[layer]


def reference_groups(cfg: ArchConfig) -> List[List[str]]:
    """``param_shapes`` paths grouped by the reference leaf that holds
    them (a layer stack's per-layer paths form one group)."""
    groups: Dict[str, List[str]] = {}
    for path in param_shapes(cfg):
        key = "/".join(_reference_path(path)[0])
        groups.setdefault(key, []).append(path)
    return list(groups.values())


def stack_layers(cfg: ArchConfig, flat: Mapping[str, torch.Tensor]
                 ) -> Dict[str, Dict]:
    """The reference's layout of ``flat`` (``param_shapes`` path ->
    tensor): nested dicts with each layer leaf stacked over its stack's
    layers, every tensor copied to the host."""
    out: Dict[str, Dict] = {}
    for paths in reference_groups(cfg):
        keys, layer = _reference_path(paths[0])
        node = out
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        leaves = [flat[p].detach().cpu() for p in paths]
        node[keys[-1]] = torch.stack(leaves) if layer is not None \
            else leaves[0]
    return out


@torch.no_grad()
def params_from_jax(cfg: ArchConfig, tree, device: DeviceLike = None
                    ) -> DenseDecoder:
    """Carry ``repro.models.model.init_params(cfg, key)`` output, converted
    leaf-by-leaf to numpy, into a :class:`DenseDecoder` on ``device``.
    The reference stacks layers as ``(L, ...)`` leaves; this unstacks them.
    Shapes must match exactly."""
    dev = resolve_device(device)
    model = DenseDecoder(cfg, dev)
    for path, shape in param_shapes(cfg).items():
        src = np.asarray(reference_leaf(tree, path))
        if tuple(src.shape) != tuple(shape):
            raise ValueError(f"{path}: reference shape {src.shape} != "
                             f"port shape {shape}")
        p = model.param(path)
        p.copy_(_to_tensor(src).to(dtype=p.dtype))
    return model


# ===========================================================================
# Decode caches
# ===========================================================================

def init_cache(cfg: ArchConfig, B: int, T: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """The cache for one-token decode with context length T, the
    reference's ``build_cache`` tree with every stacked leaf a list of
    per-layer tensors (``stack_cache`` stacks them back): K/V in
    ``param_dtype``, recurrent state in float32, ``kpos`` (int32, the
    absolute position each slot holds) filled with :data:`EMPTY_POS`.

    * plain GQA: ``k``/``v`` (B, T, Kv, hd) per layer and ``kpos`` (B, T);
    * gemma2: ``k_local``/``v_local`` rings of W = min(window, T) slots for
      the local layers, ``k_global``/``v_global`` linear T caches for the
      global ones, ``kpos_local`` (B, W) and ``kpos`` (B, T);
    * hymba: ``k``/``v`` rings of W = min(window, T) slots, ``kpos`` (B, W)
      and ``mamba`` (``conv``, ``ssm``) per layer;
    * xlstm: ``mlstm`` (``C``, ``n``, ``m``) and ``slstm`` (``c``, ``n``,
      ``m``, ``h``) per layer of each stack;
    * whisper: ``k``/``v`` (B, T, Kv, hd) per decoder layer (the
      self-attention cache), ``xk``/``xv`` (B, F, Kv, hd) per decoder
      layer (the cross-attention cache, zeros until
      :func:`encdec_cross_cache` fills it) and ``kpos`` (B, T);
    * MLA: ``c`` (B, T, r_kv) and ``rope`` (B, T, rope) per layer (the
      compressed cache, ``first_layers`` then ``layers``) and ``kpos``
      (B, T).
    """
    dev = resolve_device(device)

    def alloc(spec):
        if isinstance(spec, list):
            return [alloc(s) for s in spec]
        if isinstance(spec, dict):
            return {k: alloc(v) for k, v in spec.items()}
        shape, dt = spec
        if dt == torch.int32:           # a position leaf
            return torch.full(shape, EMPTY_POS, dtype=dt, device=dev)
        return torch.zeros(shape, dtype=dt, device=dev)

    return alloc(cache_specs(cfg, B, T))


def cache_specs(cfg: ArchConfig, B: int, T: int) -> Dict[str, Any]:
    """:func:`init_cache`'s tree with a ``(shape, dtype)`` pair for every
    tensor, nothing allocated."""
    _check_params_supported(cfg)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = _dtype(cfg)

    def kv_cache(n: int, slots: int) -> List[Tuple]:
        return [((B, slots, kv, hd), dt) for _ in range(n)]

    def positions(slots: int) -> Tuple:
        return ((B, slots), torch.int32)

    def states(specs: S.StateSpecs, n: int) -> Dict[str, List]:
        return {k: [(s, sdt) for _ in range(n)]
                for k, (s, sdt) in specs.items()}

    c: Dict[str, Any] = {}
    if cfg.block_kind == "mlstm":
        n = _stacks(cfg)
        c["mlstm"] = states(S.mlstm_state_specs(cfg, B), n["mlstm_layers"])
        if "slstm_layers" in n:
            c["slstm"] = states(S.slstm_state_specs(cfg, B),
                                n["slstm_layers"])
        return c
    if cfg.block_kind == "hymba":
        W = min(cfg.sliding_window, T) if cfg.sliding_window else T
        c["k"], c["v"] = kv_cache(cfg.num_layers, W), \
            kv_cache(cfg.num_layers, W)
        c["kpos"] = positions(W)
        c["mamba"] = states(S.mamba_state_specs(cfg, B), cfg.num_layers)
        return c
    if cfg.block_kind == "encdec":
        F = cfg.frontend_seq
        c["k"], c["v"] = kv_cache(cfg.num_layers, T), \
            kv_cache(cfg.num_layers, T)
        c["xk"], c["xv"] = kv_cache(cfg.num_layers, F), \
            kv_cache(cfg.num_layers, F)
        c["kpos"] = positions(T)
        return c
    if cfg.attention_kind == "mla":
        c["c"] = [((B, T, cfg.mla_kv_lora_rank), dt)
                  for _ in range(cfg.num_layers)]
        c["rope"] = [((B, T, cfg.mla_qk_rope_dim), dt)
                     for _ in range(cfg.num_layers)]
        c["kpos"] = positions(T)
        return c
    if cfg.local_global_period:
        n_local = (cfg.num_layers + 1) // cfg.local_global_period
        n_global = cfg.num_layers - n_local
        W = min(cfg.sliding_window, T)
        c["k_local"], c["v_local"] = kv_cache(n_local, W), \
            kv_cache(n_local, W)
        c["k_global"], c["v_global"] = kv_cache(n_global, T), \
            kv_cache(n_global, T)
        c["kpos_local"] = positions(W)
        c["kpos"] = positions(T)
        return c
    c["k"], c["v"] = kv_cache(cfg.num_layers, T), kv_cache(cfg.num_layers, T)
    c["kpos"] = positions(T)
    return c


#: logical axes of the recurrent state leaves (the reference's
#: ``*_state_specs``)
_STATE_AXES = {
    "mlstm": {"C": ("dp", "tp", None, None), "n": ("dp", "tp", None),
              "m": ("dp", "tp")},
    "slstm": {k: ("dp", "tp", None) for k in ("c", "n", "m", "h")},
    "mamba": {"conv": ("dp", None, "tp"), "ssm": ("dp", "tp", None)},
}


def cache_axes(cfg: ArchConfig, B: int, T: int) -> Dict[str, Any]:
    """The logical :class:`Axes` of every :func:`init_cache` leaf, in its
    layout (per-layer lists).  A K/V cache reads the current mesh
    (:func:`attention.kv_cache_axes`), as the reference's does."""
    def per_layer(axes, n: int):
        return [Axes(axes)] * n

    shapes = cache_specs(cfg, B, T)
    out: Dict[str, Any] = {}
    for key, leaf in shapes.items():
        if key in _STATE_AXES:
            out[key] = {k: per_layer(_STATE_AXES[key][k], len(v))
                        for k, v in leaf.items()}
        elif key.startswith("kpos"):
            out[key] = Axes(("dp", None))
        elif cfg.block_kind == "hymba":
            out[key] = per_layer(("dp", None, None, None), len(leaf))
        elif cfg.block_kind == "encdec":
            out[key] = per_layer(("dp", None, "tp", None), len(leaf))
        elif cfg.attention_kind == "mla":
            out[key] = per_layer(("dp", "sp", None), len(leaf))
        else:
            out[key] = per_layer(A.kv_cache_axes(cfg), len(leaf))
    return out


def stack_cache(cache: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's layout of a cache: each per-layer list stacked into
    one ``(L, ...)`` tensor (a copy)."""
    return {k: stack_cache(v) if isinstance(v, Mapping)
            else torch.stack(v) if isinstance(v, list) else v
            for k, v in cache.items()}


# ===========================================================================
# Full-sequence forward (train / prefill)
# ===========================================================================

def _remat(cfg: ArchConfig, fn):
    """Per-layer activation checkpointing under ``cfg.remat_policy``:
    ``"none"`` keeps every activation, ``"full"`` keeps only the layer's
    inputs and recomputes the rest in the backward, ``"dots"`` also keeps
    the outputs of the 2-D matrix products (the reference's
    ``dots_with_no_batch_dims_saveable``)."""
    if cfg.remat_policy == "none":
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        from torch.utils.checkpoint import (
            CheckpointPolicy, create_selective_checkpoint_contexts,
        )

        def policy(ctx, op, *args, **kwargs):
            return CheckpointPolicy.MUST_SAVE \
                if op == torch.ops.aten.mm.default \
                else CheckpointPolicy.PREFER_RECOMPUTE

        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _residual(x: torch.Tensor, branch: torch.Tensor) -> torch.Tensor:
    """``x + branch``, the branch first laid out as the sequence-parallel
    residual (a reduce-scatter of a row-parallel product under a mesh),
    its gradient gathered back whole over the sequence (the
    all-gather), as the matrix products that made it take it."""
    return x + shard(branch, "dp", "sp", None, grad=("dp", None, None))


def _tf_block(cfg: ArchConfig, lp, x: torch.Tensor,
              positions: Optional[torch.Tensor], *,
              window: int) -> torch.Tensor:
    # block entry: one explicit sequence all-gather; the residual itself
    # stays sequence-sharded between blocks
    h = shard(L.norm_forward(cfg, lp["ln1"], x), "dp", None, None)
    if cfg.attention_kind == "mla":
        a = A.mla_fullseq(cfg, lp["attn"], h, positions)
    else:
        a = A.gqa_fullseq(cfg, lp["attn"], h, positions, window=window)
    if cfg.post_block_norm:
        a = L.norm_forward(cfg, lp["pln1"], a)
    x = _residual(x, a)
    h = shard(L.norm_forward(cfg, lp["ln2"], x), "dp", None, None)
    if "moe" in lp:     # capacity routing over all B*S rows of the batch
        m = MOE.moe_forward(cfg, lp["moe"], h)
    else:
        m = L.mlp_forward(cfg, lp["mlp"], h)
    if cfg.post_block_norm:
        m = L.norm_forward(cfg, lp["pln2"], m)
    return shard(_residual(x, m), "dp", "sp", None)


def _tf_layers(params: DenseDecoder) -> List[nn.ModuleDict]:
    """A transformer's layers in order: ``first_layers`` (dense), then
    ``layers``."""
    return list(getattr(params, "first_layers", ())) + list(params.layers)


def _layer_window(cfg: ArchConfig, i: int) -> int:
    """Layer i's sliding window: gemma2's local layers (i % period == 0)
    use ``sliding_window``, its global layers 0 (no window)."""
    if cfg.local_global_period:
        return cfg.sliding_window if i % cfg.local_global_period == 0 else 0
    return cfg.sliding_window


def _hymba_fuse(cfg: ArchConfig, lp, x: torch.Tensor, a: torch.Tensor,
                m: torch.Tensor) -> torch.Tensor:
    """The mean of the two normed branches, then the MLP."""
    fused = 0.5 * (L.norm_forward(cfg, lp["bn_attn"], a) +
                   L.norm_forward(cfg, lp["bn_ssm"], m))
    x = _residual(x, fused)
    h = shard(L.norm_forward(cfg, lp["ln2"], x), "dp", None, None)
    return shard(_residual(x, L.mlp_forward(cfg, lp["mlp"], h)),
                 "dp", "sp", None)


def _hymba_block(cfg: ArchConfig, lp, x: torch.Tensor) -> torch.Tensor:
    """Attention (the flash kernel, windowed) and Mamba on the same
    normed input."""
    h = shard(L.norm_forward(cfg, lp["ln1"], x), "dp", None, None)
    a = A.gqa_fullseq(cfg, lp["attn"], h, None, window=cfg.sliding_window)
    m = S.mamba_fullseq(cfg, lp["mamba"], h)
    return _hymba_fuse(cfg, lp, x, a, m)


def _enc_block(cfg: ArchConfig, lp, enc: torch.Tensor) -> torch.Tensor:
    """An encoder layer: non-causal self-attention (positions play no
    part), then the MLP."""
    h = shard(L.norm_forward(cfg, lp["ln1"], enc), "dp", None, None)
    enc = _residual(enc, A.gqa_fullseq(cfg, lp["attn"], h, None,
                                       causal=False))
    h = shard(L.norm_forward(cfg, lp["ln2"], enc), "dp", None, None)
    return _residual(enc, L.mlp_forward(cfg, lp["mlp"], h))


def _dec_block(cfg: ArchConfig, lp, x: torch.Tensor,
               enc: torch.Tensor) -> torch.Tensor:
    """A decoder layer: causal self-attention, cross-attention over the
    encoder's K/V (projected by this layer's ``xattn``), then the MLP."""
    h = shard(L.norm_forward(cfg, lp["ln1"], x), "dp", None, None)
    x = _residual(x, A.gqa_fullseq(cfg, lp["attn"], h, None))
    h = shard(L.norm_forward(cfg, lp["lnx"], x), "dp", None, None)
    xk, xv = A.gqa_make_kv(cfg, lp["xattn"], enc)
    x = _residual(x, A.gqa_fullseq(cfg, lp["xattn"], h, None, causal=False,
                                   kv_override=(xk, xv)))
    h = shard(L.norm_forward(cfg, lp["ln2"], x), "dp", None, None)
    return shard(_residual(x, L.mlp_forward(cfg, lp["mlp"], h)),
                 "dp", "sp", None)


def _encode(cfg: ArchConfig, params: DenseDecoder,
            frontend: torch.Tensor) -> torch.Tensor:
    """The encoder over the frontend's frames (B, F, d), cast to the
    weights' type: + ``enc_pos``, the layers, ``enc_norm``."""
    enc = shard(frontend.to(_dtype(cfg)) + params.enc_pos[None],
                "dp", "sp", None)
    block = _remat(cfg, functools.partial(_enc_block, cfg))
    for lp in params.enc_layers:
        enc = block(lp, enc)
    return shard(L.norm_forward(cfg, params.enc_norm, enc), "dp", None, None)


def _cell_block(cfg: ArchConfig, fullseq, lp, x: torch.Tensor
                ) -> torch.Tensor:
    h = shard(L.norm_forward(cfg, lp["ln1"], x), "dp", None, None)
    return shard(_residual(x, fullseq(cfg, lp["cell"], h)),
                 "dp", "sp", None)


def _xlstm_stack(cfg: ArchConfig, params: DenseDecoder,
                 x: torch.Tensor) -> torch.Tensor:
    """The reference's grouping: one sLSTM heads each group of
    ``slstm_every`` layers, the group's mLSTM layers follow it."""
    m_block = _remat(cfg, functools.partial(_cell_block, cfg,
                                            S.mlstm_fullseq))
    s_block = _remat(cfg, functools.partial(_cell_block, cfg,
                                            S.slstm_fullseq))
    n_s = _n_slstm(cfg)
    if n_s == 0:
        for lp in params.mlstm_layers:
            x = m_block(lp, x)
        return x
    per, n_m = cfg.slstm_every - 1, cfg.num_layers - n_s
    for g in range(n_s):
        x = s_block(params.slstm_layers[g], x)
        for j in range(g * per, min(g * per + per, n_m)):
            x = m_block(params.mlstm_layers[j], x)
    return x


def forward_fullseq(cfg: ArchConfig, params: DenseDecoder,
                    tokens: torch.Tensor,
                    frontend: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Final hidden states (B,S,d) of the dense, MoE or local/global
    transformer stack, of hymba, of xlstm or of the encoder-decoder;
    every attention (self, encoder and cross) runs in the flash kernel
    (its plain version for CPU tensors).  A patch frontend's embeddings
    (B, Fs, d) replace the first Fs token embeddings (S >= Fs, as the
    reference assumes); an encoder-decoder encodes ``frontend`` (B, F, d)
    and its decoder attends to it (the reference requires it there).  An
    arch without a frontend ignores ``frontend``, as the reference does.
    Dense first layers run before the MoE stack.  The reference
    checkpoints gemma2's [local, global] pairs as one unit; here each
    layer is one."""
    _check_params_supported(cfg)
    x = L.embed_tokens(cfg, params.embed, tokens)
    if cfg.frontend == "patch" and frontend is not None:
        Fs = frontend.shape[1]
        x = torch.cat([frontend.to(x.dtype), x[:, Fs:, :]], dim=1)
    if cfg.block_kind == "encdec":
        enc = _encode(cfg, params, frontend)
        x = x + params.dec_pos[None, :x.shape[1], :]
        block = _remat(cfg, functools.partial(_dec_block, cfg))
        for lp in params.dec_layers:
            x = block(lp, x, enc)
    elif cfg.block_kind == "mlstm":
        x = _xlstm_stack(cfg, params, x)
    elif cfg.block_kind == "hymba":
        block = _remat(cfg, functools.partial(_hymba_block, cfg))
        for lp in params.layers:
            x = block(lp, x)
    else:
        for i, lp in enumerate(_tf_layers(params)):
            block = _remat(cfg, functools.partial(
                _tf_block, cfg, window=_layer_window(cfg, i)))
            x = block(lp, x, None)          # positions: arange(S)
    return L.norm_forward(cfg, params.final_norm, x)


def loss_fn(cfg: ArchConfig, params: DenseDecoder,
            batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (float32 scalar)."""
    hidden = forward_fullseq(cfg, params, batch["tokens"],
                             frontend=batch.get("frontend"))
    # gather the sequence-parallel residual once; the chunked loss then
    # keeps only (B, chunk, V/tp) logits alive
    hidden = shard(hidden, "dp", None, None)
    return L.chunked_xent(cfg, params.embed, hidden, batch["labels"])


def prefill_logits(cfg: ArchConfig, params: DenseDecoder,
                   batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Float32 logits (B,1,V) of the last position of ``batch["tokens"]``
    after the full-sequence forward."""
    hidden = forward_fullseq(cfg, params, batch["tokens"],
                             frontend=batch.get("frontend"))
    return L.logits_from_hidden(cfg, params.embed, hidden[:, -1:, :])


def encode_frontend(cfg: ArchConfig, params: DenseDecoder,
                    frontend: torch.Tensor) -> torch.Tensor:
    """The encoder run once over ``frontend`` (B, F, d): its hidden states
    (B, F, d) after ``enc_norm``."""
    if cfg.block_kind != "encdec":
        raise ValueError(f"{cfg.name} has no encoder")
    return _encode(cfg, params, frontend)


def encdec_cross_cache(cfg: ArchConfig, params: DenseDecoder,
                       frontend: torch.Tensor
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The decode cache's cross-attention K/V from one encode: per decoder
    layer, ``xk``/``xv`` (B, F, Kv, hd), the lists :func:`init_cache`
    holds (``torch.stack`` gives the reference's (L, B, F, Kv, hd))."""
    enc = encode_frontend(cfg, params, frontend)
    kv = [A.gqa_make_kv(cfg, lp["xattn"], enc) for lp in params.dec_layers]
    return [k for k, _ in kv], [v for _, v in kv]


# ===========================================================================
# Decode forward
# ===========================================================================

def _sub(state: Mapping[str, List[torch.Tensor]], i: int):
    return {k: v[i] for k, v in state.items()}


def _put(state: Mapping[str, List[torch.Tensor]], i: int,
         new: Mapping[str, torch.Tensor]):
    for k in state:
        state[k][i] = new[k]


def _decode_xlstm(cfg: ArchConfig, params: DenseDecoder, cache,
                  x: torch.Tensor) -> torch.Tensor:
    """Layer i is sLSTM where ``i % slstm_every == 0``, else the next
    mLSTM layer: the order of :func:`_xlstm_stack`."""
    im = isl = 0
    for i in range(cfg.num_layers):
        if cfg.slstm_every and i % cfg.slstm_every == 0:
            lp, key, j, step = params.slstm_layers[isl], "slstm", isl, \
                S.slstm_decode
            isl += 1
        else:
            lp, key, j, step = params.mlstm_layers[im], "mlstm", im, \
                S.mlstm_decode
            im += 1
        h = L.norm_forward(cfg, lp["ln1"], x)
        out, new = step(cfg, lp["cell"], h, _sub(cache[key], j))
        _put(cache[key], j, new)
        x = x + out
    return x


@torch.no_grad()
def decode_forward(cfg: ArchConfig, params: DenseDecoder, cache,
                   tokens: torch.Tensor, pos: torch.Tensor,
                   inputs_embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Any]:
    """One decode step.  tokens: (B,1) int; pos: (B,) positions of the new
    token.  Returns (float32 logits (B,1,V), cache).  ``cache`` (from
    :func:`init_cache`) is updated in place and returned: the token's K/V
    go to slot ``pos`` of a linear cache and ``pos % W`` of a ring, every
    ``kpos`` is updated once per step before the layers (it is shared by
    the layers), recurrent states are replaced per layer.
    ``inputs_embeds`` (B,1,d) overrides the token embedding (a VLM's
    patch positions during prefill-by-decode).  An encoder-decoder's
    step adds ``dec_pos[pos]`` and attends, after its self-attention, to
    every frame of the cross cache (``encdec_cross_cache``).  MLA decodes
    against its compressed cache through ``first_layers`` then
    ``layers``, the MoE layers dropless.  A GQA model with dense first
    layers raises: the reference's step walks ``layers`` alone for every
    layer index."""
    _check_params_supported(cfg)
    if inputs_embeds is not None:
        x = inputs_embeds.to(device=params.device, dtype=_dtype(cfg))
    else:
        x = L.embed_tokens(cfg, params.embed, tokens)
    pos = pos.to(device=x.device, dtype=torch.int32)

    def upd_pos(kp: torch.Tensor, slot: torch.Tensor):
        A.write_positions(kp, slot, pos)

    if cfg.block_kind == "mlstm":
        x = _decode_xlstm(cfg, params, cache, x)

    elif cfg.block_kind == "hymba":
        slot = (pos % cache["kpos"].shape[1]).long()
        upd_pos(cache["kpos"], slot)
        for i, lp in enumerate(params.layers):
            h = L.norm_forward(cfg, lp["ln1"], x)
            a, _, _ = A.gqa_decode(cfg, lp["attn"], h, pos, cache["k"][i],
                                   cache["v"][i], slot, cache["kpos"],
                                   window=cfg.sliding_window)
            m, new = S.mamba_decode(cfg, lp["mamba"], h,
                                    _sub(cache["mamba"], i))
            _put(cache["mamba"], i, new)
            x = _hymba_fuse(cfg, lp, x, a, m)

    elif cfg.block_kind == "encdec":
        slot = pos.long()
        upd_pos(cache["kpos"], slot)
        x = x + L.lookup_rows(params.dec_pos, slot, None)[:, None, :]
        B, F = x.shape[0], cache["xk"][0].shape[1]
        xk_positions = torch.arange(F, dtype=torch.int32,
                                    device=x.device).expand(B, F)
        full_len = torch.full((B,), F - 1, dtype=torch.int32,
                              device=x.device)
        for i, lp in enumerate(params.dec_layers):
            h = L.norm_forward(cfg, lp["ln1"], x)
            a, _, _ = A.gqa_decode(cfg, lp["attn"], h, pos, cache["k"][i],
                                   cache["v"][i], slot, cache["kpos"])
            x = x + a
            h = L.norm_forward(cfg, lp["lnx"], x)
            q = A.project_heads(h, lp["xattn"]["wq"])
            xa = A.attend_by_heads(q, cache["xk"][i], cache["xv"][i],
                                   lengths=full_len,
                                   k_positions=xk_positions)
            x = x + A.out_proj(lp["xattn"], xa)
            h = L.norm_forward(cfg, lp["ln2"], x)
            x = x + L.mlp_forward(cfg, lp["mlp"], h)

    elif cfg.attention_kind == "mla":
        slot = pos.long()
        upd_pos(cache["kpos"], slot)
        for i, lp in enumerate(_tf_layers(params)):
            h = L.norm_forward(cfg, lp["ln1"], x)
            a, _, _ = A.mla_decode(cfg, lp["attn"], h, pos, cache["c"][i],
                                   cache["rope"][i], slot, cache["kpos"])
            if cfg.post_block_norm:
                a = L.norm_forward(cfg, lp["pln1"], a)
            x = x + a
            h = L.norm_forward(cfg, lp["ln2"], x)
            if "moe" in lp:
                m = MOE.moe_forward(cfg, lp["moe"], h, dropless=True)
            else:
                m = L.mlp_forward(cfg, lp["mlp"], h)
            x = x + m

    elif cfg.local_global_period:
        slot_local = (pos % cache["kpos_local"].shape[1]).long()
        slot_global = pos.long()
        upd_pos(cache["kpos_local"], slot_local)
        upd_pos(cache["kpos"], slot_global)
        il = ig = 0
        for i, lp in enumerate(params.layers):
            h = L.norm_forward(cfg, lp["ln1"], x)
            if i % cfg.local_global_period == 0:
                a, _, _ = A.gqa_decode(
                    cfg, lp["attn"], h, pos, cache["k_local"][il],
                    cache["v_local"][il], slot_local, cache["kpos_local"],
                    window=cfg.sliding_window)
                il += 1
            else:
                a, _, _ = A.gqa_decode(
                    cfg, lp["attn"], h, pos, cache["k_global"][ig],
                    cache["v_global"][ig], slot_global, cache["kpos"])
                ig += 1
            if cfg.post_block_norm:
                a = L.norm_forward(cfg, lp["pln1"], a)
            x = x + a
            h = L.norm_forward(cfg, lp["ln2"], x)
            m = L.mlp_forward(cfg, lp["mlp"], h)
            if cfg.post_block_norm:
                m = L.norm_forward(cfg, lp["pln2"], m)
            x = x + m

    else:  # plain GQA transformer (incl. MoE: olmoe)
        if _n_first(cfg):
            raise NotImplementedError(
                f"{cfg.name}: the reference's GQA decode step walks "
                "`layers` alone, past its dense first layers")
        slot = pos.long()
        upd_pos(cache["kpos"], slot)
        for i, lp in enumerate(params.layers):
            h = L.norm_forward(cfg, lp["ln1"], x)
            a, _, _ = A.gqa_decode(cfg, lp["attn"], h, pos, cache["k"][i],
                                   cache["v"][i], slot, cache["kpos"],
                                   window=_layer_window(cfg, i))
            x = x + a
            h = L.norm_forward(cfg, lp["ln2"], x)
            if "moe" in lp:
                m = MOE.moe_forward(cfg, lp["moe"], h, dropless=True)
            else:
                m = L.mlp_forward(cfg, lp["mlp"], h)
            x = x + m

    x = L.norm_forward(cfg, params.final_norm, x)
    return L.logits_from_hidden(cfg, params.embed, x), cache
