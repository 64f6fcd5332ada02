"""The dense GQA decoder as an ``nn.Module``, with the reference's layout.

Parameters keep ``repro.models.model``'s names and shapes, per layer
instead of stacked: ``attn.wq (d,H,hd)``, ``attn.wk/wv (d,Kv,hd)``,
``attn.wo (H,hd,d)``, ``mlp.w_gate/w_up (d,ff)``, ``mlp.w_down (ff,d)``,
``embed.table/head (V,d)`` and the norms' ``scale`` (always float32).
Every container is an ``nn.ParameterDict`` / ``nn.ModuleDict``, so the
layer functions index it exactly as the reference indexes its pytree
(``lp["attn"]["wq"]``).  The serving forward lives with the engine
(``runtime.server._paged_forward``), as in the reference.

Two ways to fill it:

* :func:`init_params` — ``normal / sqrt(fan_in)`` draws (the reference's
  ``ParamFactory`` rule) from an explicit ``torch.Generator``;
* :func:`params_from_jax` — carry the reference's ``init_params`` output
  (a pytree of numpy arrays, layers stacked as ``(L, ...)`` leaves) into
  the port, so both sides compute on identical weights.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device


def _check_supported(cfg: ArchConfig):
    if cfg.moe_num_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (dense GQA only)")
    if not (cfg.block_kind == "transformer" and cfg.attention_kind == "gqa"
            and not cfg.local_global_period and not cfg.post_block_norm
            and not cfg.frontend):
        raise NotImplementedError(
            f"{cfg.name}: only plain dense GQA decoders are ported")


def _layer_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d, H, K = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, ff = cfg.resolved_head_dim, cfg.d_ff
    out = {"ln1/scale": (d,), "attn/wq": (d, H, hd), "attn/wk": (d, K, hd),
           "attn/wv": (d, K, hd), "attn/wo": (H, hd, d)}
    if cfg.use_qk_norm:
        out["attn/q_norm"] = (hd,)
        out["attn/k_norm"] = (hd,)
    out["ln2/scale"] = (d,)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        out["mlp/w_gate"] = (d, ff)
    out["mlp/w_up"] = (d, ff)
    out["mlp/w_down"] = (ff, d)
    return out


def param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's path -> shape, in init order."""
    _check_supported(cfg)
    V, d = cfg.vocab_size, cfg.d_model
    out: Dict[str, Tuple[int, ...]] = {"embed/table": (V, d)}
    if not cfg.tie_embeddings:
        out["embed/head"] = (V, d)
    for i in range(cfg.num_layers):
        for k, s in _layer_shapes(cfg).items():
            out[f"layers/{i}/{k}"] = s
    out["final_norm/scale"] = (d,)
    return out


def _fan_in(cfg: ArchConfig, path: str, shape: Tuple[int, ...]) -> int:
    """The reference ParamFactory's fan-in: the first dim unless the
    reference's parameter definition names another (``wo``: H*hd,
    ``w_down``: ff, embeddings: d)."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "wo":
        return cfg.num_heads * cfg.resolved_head_dim
    if leaf == "w_down":
        return cfg.d_ff
    if path.startswith("embed/"):
        return cfg.d_model
    return shape[0]


def _is_norm(path: str) -> bool:
    leaf = path.rsplit("/", 1)[-1]
    return leaf in ("q_norm", "k_norm") or path.endswith("scale")


def _pdict(shapes: Mapping[str, Tuple[int, ...]], dtype, device):
    return nn.ParameterDict({
        k: nn.Parameter(torch.empty(s, dtype=torch.float32 if
                                    _is_norm(k) else dtype, device=device),
                        requires_grad=False)
        for k, s in shapes.items()})


class DenseDecoder(nn.Module):
    """Dense GQA decoder weights: ``embed``, ``layers[i]`` (``ln1``,
    ``attn``, ``ln2``, ``mlp``) and ``final_norm``.  Inference only: every
    parameter has ``requires_grad=False``."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        dtype = getattr(torch, cfg.param_dtype)
        V, d = cfg.vocab_size, cfg.d_model
        emb = {"table": (V, d)}
        if not cfg.tie_embeddings:
            emb["head"] = (V, d)
        self.embed = _pdict(emb, dtype, device)
        groups: Dict[str, Dict[str, Tuple[int, ...]]] = {}
        for path, s in _layer_shapes(cfg).items():
            g, leaf = path.split("/")
            groups.setdefault(g, {})[leaf] = s
        self.layers = nn.ModuleList([
            nn.ModuleDict({g: _pdict(ls, dtype, device)
                           for g, ls in groups.items()})
            for _ in range(cfg.num_layers)])
        self.final_norm = _pdict({"scale": (d,)}, dtype, device)

    def param(self, path: str) -> torch.Tensor:
        """The parameter at a ``param_shapes`` path."""
        parts = path.split("/")
        if parts[0] == "layers":
            return self.layers[int(parts[1])][parts[2]][parts[3]]
        return getattr(self, parts[0])[parts[1]]

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0,
                device: DeviceLike = None) -> DenseDecoder:
    """Random weights from ``seed``: norms are ones, every other leaf is
    ``normal / sqrt(fan_in)`` drawn in float32 then cast to
    ``cfg.param_dtype``.  The draws come from a ``torch.Generator`` on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``), so the same
    seed gives the same weights on the same device type, not across
    device types."""
    dev = resolve_device(device)
    model = DenseDecoder(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for path, shape in param_shapes(cfg).items():
        p = model.param(path)
        if _is_norm(path):
            p.fill_(1.0)
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
        parts = path.split("/")
        if parts[0] == "layers":
            i, group, leaf = int(parts[1]), parts[2], parts[3]
            src = np.asarray(tree["layers"][group][leaf])[i]
        else:
            src = np.asarray(tree[parts[0]][parts[1]])
        if tuple(src.shape) != tuple(shape):
            raise ValueError(f"{path}: reference shape {src.shape} != "
                             f"port shape {shape}")
        p = model.param(path)
        p.copy_(_to_tensor(src).to(dtype=p.dtype))
    return model
