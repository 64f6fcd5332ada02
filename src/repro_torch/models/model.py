"""The GQA decoder as an ``nn.Module``, with the reference's layout, and
its full-sequence forward and loss (the training path).

Parameters keep ``repro.models.model``'s names and shapes, per layer
instead of stacked: ``attn.wq (d,H,hd)``, ``attn.wk/wv (d,Kv,hd)``,
``attn.wo (H,hd,d)``, ``mlp.w_gate/w_up (d,ff)``, ``mlp.w_down (ff,d)``,
``embed.table/head (V,d)`` (no ``head`` with tied embeddings), gemma2's
post-block norms ``pln1``/``pln2`` and the norms' ``scale`` (always
float32).  A routed-expert (MoE) layer holds ``moe.router (d,E)`` (always
float32), ``moe.w_gate/w_up (E,d,f)`` and ``moe.w_down (E,f,d)`` in place
of ``mlp``, and with shared experts ``moe.shared.{w_gate,w_up,w_down}``.
Every container is an ``nn.ParameterDict`` / ``nn.ModuleDict`` (nested
for ``moe.shared``), so the layer functions index it exactly as the
reference indexes its pytree (``lp["attn"]["wq"]``).  The serving
forward lives with the engine (``runtime.server._paged_forward``), as in
the reference; the paged server refuses what it does not serve
(:func:`_check_supported`).

Two ways to fill it:

* :func:`init_params` — ``normal / sqrt(fan_in)`` draws (the reference's
  ``ParamFactory`` rule) from an explicit ``torch.Generator``;
* :func:`params_from_jax` — carry the reference's ``init_params`` output
  (a pytree of numpy arrays, layers stacked as ``(L, ...)`` leaves) into
  the port, so both sides compute on identical weights.

:func:`forward_fullseq` and :func:`loss_fn` are the training path's
forward for the dense, MoE and local/global (gemma2) transformer stacks,
with per-layer activation checkpointing under ``cfg.remat_policy``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE


def _check_params_supported(cfg: ArchConfig):
    """The parameter layouts ported so far: GQA transformers, dense or
    with routed experts in every layer, with or without gemma2's
    local/global layers and post-block norms."""
    if cfg.moe_num_experts and cfg.moe_first_dense_layers:
        raise NotImplementedError(
            f"{cfg.name}: dense first layers before the MoE stack are not "
            "ported yet")
    if not (cfg.block_kind == "transformer" and cfg.attention_kind == "gqa"
            and not cfg.frontend):
        raise NotImplementedError(
            f"{cfg.name}: only GQA decoders are ported")


def _check_supported(cfg: ArchConfig):
    """The paged server's guard: plain GQA decoders only, dense or MoE (no
    local/global layers, which the reference's server refuses too, and
    no post-block norms, which its paged forward does not apply)."""
    _check_params_supported(cfg)
    if cfg.local_global_period or cfg.post_block_norm:
        raise NotImplementedError(
            f"{cfg.name}: the paged server serves plain GQA decoders only")


def _mlp_shapes(cfg: ArchConfig, group: str, ff: int
                ) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    out = {}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        out[f"{group}/w_gate"] = (d, ff)
    out[f"{group}/w_up"] = (d, ff)
    out[f"{group}/w_down"] = (ff, d)
    return out


def _layer_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d, H, K = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, ff = cfg.resolved_head_dim, cfg.d_ff
    out = {"ln1/scale": (d,), "attn/wq": (d, H, hd), "attn/wk": (d, K, hd),
           "attn/wv": (d, K, hd), "attn/wo": (H, hd, d)}
    if cfg.use_qk_norm:
        out["attn/q_norm"] = (hd,)
        out["attn/k_norm"] = (hd,)
    out["ln2/scale"] = (d,)
    if cfg.moe_num_experts:
        E, f = cfg.moe_num_experts, cfg.moe_d_ff
        out["moe/router"] = (d, E)
        out["moe/w_gate"] = (E, d, f)
        out["moe/w_up"] = (E, d, f)
        out["moe/w_down"] = (E, f, d)
        if cfg.moe_shared_experts:
            out.update(_mlp_shapes(cfg, "moe/shared",
                                   f * cfg.moe_shared_experts))
    else:
        out.update(_mlp_shapes(cfg, "mlp", ff))
    if cfg.post_block_norm:
        out["pln1/scale"] = (d,)
        out["pln2/scale"] = (d,)
    return out


def param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's path -> shape, in init order."""
    _check_params_supported(cfg)
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
    reference's parameter definition names another (``wo``: H*hd, a dense
    ``w_down``: its ff, an expert ``w_down``: ``moe_d_ff``, embeddings:
    d).  So the experts' ``w_gate``/``w_up`` (E, d, f) draw with fan-in
    E, as the reference's do."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "wo":
        return cfg.num_heads * cfg.resolved_head_dim
    if leaf == "w_down":
        return shape[-2]
    if path.startswith("embed/"):
        return cfg.d_model
    return shape[0]


def _is_norm(path: str) -> bool:
    leaf = path.rsplit("/", 1)[-1]
    return leaf in ("q_norm", "k_norm") or path.endswith("scale")


def _is_f32(path: str) -> bool:
    """Leaves kept in float32 whatever ``param_dtype`` is: the norms and
    the MoE router."""
    return _is_norm(path) or path.endswith("moe/router")


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
        out[k] = nn.Parameter(torch.empty(
            s, dtype=torch.float32 if _is_f32(prefix + k) else dtype,
            device=device), requires_grad=False)
    for head, shp in sub.items():
        out[head] = _pdict(shp, dtype, device, f"{prefix}{head}/")
    return out


class DenseDecoder(nn.Module):
    """GQA decoder weights: ``embed``, ``layers[i]`` (``ln1``, ``attn``,
    ``ln2``, ``mlp`` or ``moe``, and ``pln1``/``pln2`` with post-block
    norms) and ``final_norm``.  Every parameter starts with
    ``requires_grad=False`` (serving); the training path's
    ``steps.init_train_state`` switches it on."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        _check_params_supported(cfg)
        self.cfg = cfg
        dtype = getattr(torch, cfg.param_dtype)
        V, d = cfg.vocab_size, cfg.d_model
        emb = {"table": (V, d)}
        if not cfg.tie_embeddings:
            emb["head"] = (V, d)
        self.embed = _pdict(emb, dtype, device)
        groups: Dict[str, Dict[str, Tuple[int, ...]]] = {}
        for path, s in _layer_shapes(cfg).items():
            g, rest = path.split("/", 1)
            groups.setdefault(g, {})[rest] = s
        self.layers = nn.ModuleList([
            nn.ModuleDict({g: _pdict(ls, dtype, device, f"{g}/")
                           for g, ls in groups.items()})
            for _ in range(cfg.num_layers)])
        self.final_norm = _pdict({"scale": (d,)}, dtype, device)

    def param(self, path: str) -> torch.Tensor:
        """The parameter at a ``param_shapes`` path."""
        parts = path.split("/")
        if parts[0] == "layers":
            node = self.layers[int(parts[1])]
            parts = parts[2:]
        else:
            node = getattr(self, parts.pop(0))
        for part in parts:
            node = node[part]
        return node

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


def _reference_path(path: str) -> Tuple[List[str], Optional[int]]:
    """A ``param_shapes`` path as the reference tree's keys, and the layer
    index into the stacked leaf (None outside the layer stack):
    ``layers/3/moe/shared/w_up`` -> (``[layers, moe, shared, w_up]``, 3)."""
    parts = path.split("/")
    if parts[0] == "layers":
        return [parts[0]] + parts[2:], int(parts[1])
    return parts, None


def reference_leaf(tree, path: str):
    """What a tree in the reference's layout (layers stacked as ``(L,
    ...)`` leaves) holds for the port's parameter ``path``: layer i's
    slice of the stacked leaf for ``layers/i/...``."""
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
    tensor): nested dicts with each layer leaf stacked over the layers,
    every tensor copied to the host."""
    out: Dict[str, Dict] = {}
    for paths in reference_groups(cfg):
        keys, _ = _reference_path(paths[0])
        node = out
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        leaves = [flat[p].detach().cpu() for p in paths]
        node[keys[-1]] = torch.stack(leaves) \
            if paths[0].startswith("layers/") else leaves[0]
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


def _tf_block(cfg: ArchConfig, lp, x: torch.Tensor,
              positions: Optional[torch.Tensor], *,
              window: int) -> torch.Tensor:
    h = L.norm_forward(cfg, lp["ln1"], x)
    a = A.gqa_fullseq(cfg, lp["attn"], h, positions, window=window)
    if cfg.post_block_norm:
        a = L.norm_forward(cfg, lp["pln1"], a)
    x = x + a
    h = L.norm_forward(cfg, lp["ln2"], x)
    if "moe" in lp:     # capacity routing over all B*S rows of the batch
        m = MOE.moe_forward(cfg, lp["moe"], h)
    else:
        m = L.mlp_forward(cfg, lp["mlp"], h)
    if cfg.post_block_norm:
        m = L.norm_forward(cfg, lp["pln2"], m)
    return x + m


def _layer_window(cfg: ArchConfig, i: int) -> int:
    """Layer i's sliding window: gemma2's local layers (i % period == 0)
    use ``sliding_window``, its global layers 0 (no window)."""
    if cfg.local_global_period:
        return cfg.sliding_window if i % cfg.local_global_period == 0 else 0
    return cfg.sliding_window


def forward_fullseq(cfg: ArchConfig, params: DenseDecoder,
                    tokens: torch.Tensor,
                    frontend: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Final hidden states (B,S,d) of the dense, MoE or local/global
    transformer stack; every layer's self-attention runs in the flash
    kernel (its plain version for CPU tensors).  Frontends, MLA, dense
    first layers before an MoE stack and the other block kinds raise
    until their families are ported (so ``frontend`` is ignored, as the
    reference ignores it for an arch without one).  The reference
    checkpoints gemma2's [local, global] pairs as one unit; here each
    layer is one."""
    _check_params_supported(cfg)
    del frontend
    x = L.embed_tokens(cfg, params.embed, tokens)
    for i, lp in enumerate(params.layers):
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
    return L.chunked_xent(cfg, params.embed, hidden, batch["labels"])
