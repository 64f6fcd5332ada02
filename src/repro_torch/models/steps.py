"""Step builders and the train state, the port of ``repro.models.steps``.

    train_step(state, batch)          -> (state, metrics)
    prefill_step(params, batch)       -> logits (B,1,V)
    decode_step(params, cache, batch) -> (logits, cache)

The state is ``{"params": DenseDecoder, "opt": {"m", "v", "step",
"master"}, "resid"}`` (``resid`` with gradient compression), the
optimizer's dicts keyed by ``model.param_shapes`` paths.  The step runs
eagerly: ``loss.backward()``, the gradients taken off the parameters,
the optional error-feedback compression, then AdamW in place.  The
reference jits the step and donates the state; here the state is updated
in place and the same dict comes back (the decode step updates its
cache in place too).  :func:`input_specs` gives every model input's
``(shape, dtype)`` and :func:`make_batch` draws a batch of them from a
``torch.Generator``.

The sharded step: :func:`input_axes`, :func:`train_state_specs` and
:func:`train_state_axes` give every input and every leaf of the state
its shape and logical axes, and :func:`lowerable` lays them over a
``DeviceMesh`` as DTensors (``parallel.sharding.placements``) and
returns the same eager step to run on them under the mesh and a
sharding profile, so the model's own ``shard`` constraints resolve
against that mesh.  The dry-run (``launch.dryrun``) runs it on fake
tensors; over a ``gloo`` group it runs on real ones.

:func:`state_tree` and :func:`load_state_tree` map the state to and from
the reference's train-state layout (layers stacked as ``(L, ...)``), the
layout checkpoints are written in, so either package restores the
other's.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import DeviceLike
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.compress import ef_compress_grads, init_residual
from repro_torch.parallel.sharding import (
    Axes, mesh_context, placements, sharding_profile, tree_map_axes,
)


def default_opt_cfg(cfg: ArchConfig) -> AdamWConfig:
    # huge models skip the fp32 master copy to fit device memory
    big = cfg.name in ("deepseek-v2-236b", "qwen3-32b", "pixtral-12b",
                       "minitron-8b")
    return AdamWConfig(use_master=not big)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeSpec
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Every model input of ``shape``'s step, name -> (shape, dtype): the
    reference's keys, shapes and types.  An arch with a frontend takes
    its stub embeddings ``frontend`` (B, frontend_seq, d_model) in the
    weights' type for train and prefill; decode takes none."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out = {"tokens": ((B, S), torch.int32)}
        if shape.kind == "train":
            out["labels"] = ((B, S), torch.int32)
        if cfg.frontend:
            out["frontend"] = ((B, cfg.frontend_seq, cfg.d_model),
                               getattr(torch, cfg.param_dtype))
        return out
    # decode: one new token against a cache of S
    return {"tokens": ((B, 1), torch.int32), "pos": ((B,), torch.int32)}


def input_axes(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Axes]:
    """The logical axes of every input of :func:`input_specs`."""
    if shape.kind == "decode":
        return {"tokens": Axes(("dp", None)), "pos": Axes(("dp",))}
    out = {"tokens": Axes(("dp", None))}
    if shape.kind == "train":
        out["labels"] = Axes(("dp", None))
    if cfg.frontend:
        out["frontend"] = Axes(("dp", None, None))
    return out


def make_batch(cfg: ArchConfig, shape: ShapeSpec, gen: torch.Generator
               ) -> Dict[str, torch.Tensor]:
    """A synthetic batch matching :func:`input_specs`, drawn from ``gen``
    on its device: tokens and labels uniform over the vocabulary, ``pos``
    ``seq_len - 1``, ``frontend`` normal x 0.02 (the data pipeline's
    scale) drawn in float32 and cast."""
    out: Dict[str, torch.Tensor] = {}
    for k, (s, dt) in input_specs(cfg, shape).items():
        if k == "pos":
            out[k] = torch.full(s, shape.seq_len - 1, dtype=dt,
                                device=gen.device)
        elif k == "frontend":
            out[k] = (torch.randn(s, generator=gen, dtype=torch.float32,
                                  device=gen.device) * 0.02).to(dt)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, s, generator=gen,
                                   dtype=dt, device=gen.device)
    return out


# ---------------------------------------------------------------------------
# Train state and steps
# ---------------------------------------------------------------------------

def named_params(model: M.DenseDecoder) -> Dict[str, torch.Tensor]:
    """``param_shapes`` path -> the model's parameter."""
    return {path: model.param(path) for path in M.param_shapes(model.cfg)}


def init_train_state(cfg: ArchConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     compress: bool = False, device: DeviceLike = None,
                     params: Optional[M.DenseDecoder] = None
                     ) -> Dict[str, Any]:
    """Weights from ``init_params(cfg, seed, device)`` (or ``params``, e.g.
    from ``params_from_jax``), made trainable, with a fresh optimizer
    state beside them."""
    model = params if params is not None else M.init_params(cfg, seed,
                                                            device)
    model.requires_grad_(True)
    named = named_params(model)
    st: Dict[str, Any] = {"params": model,
                          "opt": init_opt_state(named, opt_cfg)}
    if compress:
        st["resid"] = init_residual(named)
    return st


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                    compress: bool = False):
    opt_cfg = opt_cfg or default_opt_cfg(cfg)

    def train_step(state: Dict[str, Any],
                   batch: Mapping[str, torch.Tensor]):
        named = named_params(state["params"])
        for p in named.values():
            p.grad = None
        loss = M.loss_fn(cfg, state["params"], batch)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        for p in named.values():
            p.grad = None
        if compress:
            grads, state["resid"] = ef_compress_grads(
                grads, state["resid"], M.reference_groups(cfg))
        _, state["opt"], metrics = adamw_update(named, grads, state["opt"],
                                                opt_cfg)
        del grads
        return state, dict(metrics, loss=loss.detach())

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params: M.DenseDecoder,
                     batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return M.prefill_logits(cfg, params, batch)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params: M.DenseDecoder, cache,
                    batch: Mapping[str, torch.Tensor]):
        return M.decode_forward(cfg, params, cache, batch["tokens"],
                                batch["pos"])
    return decode_step


def state_tree(cfg: ArchConfig, state: Mapping[str, Any]) -> Dict[str, Any]:
    """The train state in the reference's layout, on the host: params,
    ``opt`` (``m``, ``v``, ``step``, ``master``) and ``resid`` as nested
    dicts with the layers stacked."""
    opt = state["opt"]
    tree: Dict[str, Any] = {
        "params": M.stack_layers(cfg, named_params(state["params"])),
        "opt": {k: M.stack_layers(cfg, opt[k]) for k in ("m", "v", "master")
                if k in opt}}
    tree["opt"]["step"] = opt["step"].detach().cpu()
    if "resid" in state:
        tree["resid"] = M.stack_layers(cfg, state["resid"])
    return tree


@torch.no_grad()
def load_state_tree(cfg: ArchConfig, state: Dict[str, Any],
                    tree: Mapping[str, Any]) -> Dict[str, Any]:
    """Copy a tree in the reference's layout (as :func:`state_tree` gives
    it, or a checkpoint of either package restores it) into ``state``, in
    place; shapes and types must match."""
    def fill(flat: Mapping[str, torch.Tensor], sub, what: str):
        for path, dst in flat.items():
            src = torch.as_tensor(M.reference_leaf(sub, path))
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(f"{what}/{path}: {src.dtype} "
                                 f"{tuple(src.shape)} != {dst.dtype} "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

    fill(named_params(state["params"]), tree["params"], "params")
    opt = state["opt"]
    for k in ("m", "v", "master"):
        if k in opt:
            fill(opt[k], tree["opt"][k], f"opt/{k}")
    opt["step"].copy_(torch.as_tensor(tree["opt"]["step"]))
    if "resid" in state:
        fill(state["resid"], tree["resid"], "resid")
    return state


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

def train_state_specs(cfg: ArchConfig, opt_cfg: AdamWConfig,
                      compress: bool = False) -> Dict[str, Any]:
    """The train state's tree with a ``(shape, dtype)`` pair for every
    tensor: ``params`` in their types, ``m``, ``v``, ``master`` and
    ``resid`` in float32, ``step`` an int32 scalar."""
    p = M.param_specs(cfg)
    f32 = {path: (s, torch.float32) for path, (s, _) in p.items()}
    opt: Dict[str, Any] = {"m": f32, "v": dict(f32),
                           "step": ((), torch.int32)}
    if opt_cfg.use_master:
        opt["master"] = dict(f32)
    st = {"params": p, "opt": opt}
    if compress:
        st["resid"] = dict(f32)
    return st


def train_state_axes(cfg: ArchConfig, opt_cfg: AdamWConfig,
                     compress: bool = False) -> Dict[str, Any]:
    """The logical axes of :func:`train_state_specs`: every optimizer
    leaf those of its parameter, ``step`` none."""
    ax = M.param_axes(cfg)
    opt: Dict[str, Any] = {"m": ax, "v": ax, "step": Axes(())}
    if opt_cfg.use_master:
        opt["master"] = ax
    st = {"params": ax, "opt": opt}
    if compress:
        st["resid"] = ax
    return st


def _dtensors(spec_tree, axes_tree, mesh, fill=None):
    """A DTensor of every ``(shape, dtype)`` leaf, laid out by its logical
    axes over ``mesh``: zeros, int32 leaves ``fill`` where given.  Under
    a ``FakeTensorMode`` the local shards are fake."""
    from torch.distributed import tensor as dt

    def make(spec, axes):
        shape, dtype = spec
        pl = placements(shape, axes, mesh)
        if fill is not None and dtype == torch.int32:
            return dt.full(shape, fill, dtype=dtype, device_mesh=mesh,
                           placements=pl)
        return dt.zeros(shape, dtype=dtype, device_mesh=mesh,
                        placements=pl)
    return tree_map_axes(make, spec_tree, axes_tree)


def sharded_model(cfg: ArchConfig, tensors: Mapping[str, torch.Tensor]
                  ) -> M.DenseDecoder:
    """A :class:`DenseDecoder` whose parameters are ``tensors``
    (``param_shapes`` path -> tensor, e.g. DTensors), built on the meta
    device so no full-size weight is ever allocated."""
    model = M.DenseDecoder(cfg, torch.device("meta"))
    for path, t in tensors.items():
        M.set_param(model, path, t)
    return model


def lowerable(cfg: ArchConfig, shape: ShapeSpec, mesh,
              opt_cfg: Optional[AdamWConfig] = None,
              compress: bool = False, profile: str = "megatron"):
    """``(fn, args)``: ``fn(*args)`` runs ``shape``'s step on DTensors laid
    out over ``mesh`` by the logical axes (under a ``FakeTensorMode``
    the shards are fake and nothing is allocated).  The args are the
    train state and batch (train), the params and batch (prefill), or
    the params, cache and batch (decode); ``fn`` is the eager
    :func:`make_train_step` / :func:`make_prefill_step` /
    :func:`make_decode_step` run under ``sharding_profile(profile)``,
    ``mesh_context(mesh)`` and DTensor's implicit replication (a plain
    tensor the model makes, a mask or a position, is the same on every
    device)."""
    from torch.distributed.tensor.experimental import implicit_replication
    opt_cfg = opt_cfg or default_opt_cfg(cfg)
    with sharding_profile(profile), mesh_context(mesh):
        batch = _dtensors(input_specs(cfg, shape), input_axes(cfg, shape),
                          mesh)
        if shape.kind == "train":
            st = _dtensors(train_state_specs(cfg, opt_cfg, compress),
                           train_state_axes(cfg, opt_cfg, compress), mesh)
            st["params"] = sharded_model(cfg, st["params"])
            st["params"].requires_grad_(True)
            step = make_train_step(cfg, opt_cfg, compress)
            args = (st, batch)
        else:
            params = sharded_model(cfg, _dtensors(
                M.param_specs(cfg), M.param_axes(cfg), mesh))
            if shape.kind == "prefill":
                step = make_prefill_step(cfg)
                args = (params, batch)
            else:
                T = max(cfg.cache_len(shape), 1)
                B = shape.global_batch
                cache = _dtensors(M.cache_specs(cfg, B, T),
                                  M.cache_axes(cfg, B, T), mesh,
                                  fill=M.EMPTY_POS)
                step = make_decode_step(cfg)
                args = (params, cache, batch)

    def fn(*a):
        with sharding_profile(profile), mesh_context(mesh), \
                implicit_replication():
            return step(*a)
    return fn, args
