"""Random weights made on the device from the seed, in the type served.

Every matrix of the model is a view into one bf16 buffer filled by one
``normal_`` call of a ``torch.Generator`` on the device; a leaf is scaled
by 1 / sqrt(its fan-in), and leaves of one fan-in lie side by side, so
that takes one multiply per fan-in.  Norm scales are ones; an MoE router
is float32, drawn the same way.  The port and the reference get the same
tensors, under the port's parameter paths.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Shapes = List[Tuple[str, Tuple[int, ...]]]


def layout(conf: dict) -> Tuple[Dict[int, Shapes], Shapes, Shapes]:
    """(bf16 matrices by fan-in, float32 matrices, ones) as
    (path, shape) lists, from a configuration file's keys."""
    d, L = conf["hidden_size"], conf["num_hidden_layers"]
    H, Kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // H
    V, ff = conf["vocab_size"], conf["intermediate_size"]
    E = conf.get("num_experts", 0)
    mats: Dict[int, Shapes] = {}

    def mat(fan_in: int, path: str, shape: Tuple[int, ...]):
        mats.setdefault(fan_in, []).append((path, shape))

    mat(d, "embed/table", (V, d))
    if not conf.get("tie_word_embeddings", False):
        mat(d, "embed/head", (V, d))
    f32: Shapes = []
    ones: Shapes = [("final_norm/scale", (d,))]
    for i in range(L):
        p = f"layers/{i}"
        mat(d, f"{p}/attn/wq", (d, H, hd))
        mat(d, f"{p}/attn/wk", (d, Kv, hd))
        mat(d, f"{p}/attn/wv", (d, Kv, hd))
        mat(H * hd, f"{p}/attn/wo", (H, hd, d))
        ones += [(f"{p}/ln1/scale", (d,)), (f"{p}/ln2/scale", (d,))]
        if conf.get("qk_norm"):
            ones += [(f"{p}/attn/q_norm", (hd,)), (f"{p}/attn/k_norm", (hd,))]
        if E:
            f32.append((f"{p}/moe/router", (d, E)))
            mat(d, f"{p}/moe/w_gate", (E, d, ff))
            mat(d, f"{p}/moe/w_up", (E, d, ff))
            mat(ff, f"{p}/moe/w_down", (E, ff, d))
        else:
            mat(d, f"{p}/mlp/w_gate", (d, ff))
            mat(d, f"{p}/mlp/w_up", (d, ff))
            mat(ff, f"{p}/mlp/w_down", (ff, d))
    return mats, f32, ones


def _views(buf: torch.Tensor, shapes: Shapes, at: int,
           out: Dict[str, torch.Tensor]) -> int:
    for path, shape in shapes:
        n = math.prod(shape)
        out[path] = buf[at:at + n].view(shape)
        at += n
    return at


@torch.no_grad()
def make(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of the model, path -> tensor on ``device``."""
    mats, f32, ones = layout(conf)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out: Dict[str, torch.Tensor] = {}
    total = sum(math.prod(s) for group in mats.values() for _, s in group)
    buf = torch.empty(total, dtype=torch.bfloat16, device=device)
    buf.normal_(generator=gen)
    at = 0
    for fan_in, group in mats.items():
        start = at
        at = _views(buf, group, at, out)
        buf[start:at].mul_(1.0 / math.sqrt(fan_in))
    if f32:
        fbuf = torch.empty(sum(math.prod(s) for _, s in f32),
                           dtype=torch.float32, device=device)
        fbuf.normal_(generator=gen)
        fbuf.mul_(1.0 / math.sqrt(conf["hidden_size"]))
        _views(fbuf, f32, 0, out)
    obuf = torch.ones(sum(math.prod(s) for _, s in ones),
                      dtype=torch.float32, device=device)
    _views(obuf, ones, 0, out)
    return out


def nbytes(weights: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in weights.values())
