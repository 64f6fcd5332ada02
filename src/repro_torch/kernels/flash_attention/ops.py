"""Public flash-attention op: the kernel's forward and an exact recompute
backward, as ``repro.kernels.flash_attention.ops``.

``flash_attention`` is a ``torch.autograd.Function``.  Its forward is the
hand-written CUDA kernel (``kernel.py``) for CUDA tensors and the plain
version (``ref.py``) for CPU tensors, chosen by device with no fallback
from one to the other.  Its backward does what the reference's ``_bwd``
does: it recomputes the attention through ``flash_attention_ref`` under
autograd, with K/V ``repeat_interleave``d by ``groups`` for the
recompute only, so the grads of the query heads that share a KV head are
summed back onto it.  That backward is the reference's XLA backward, not
a Pallas kernel, so it stays plain PyTorch: it is the one place where the
plain version runs on the card (counted by :data:`backward_recomputes`).

v may have its own head dim ``dv`` beside q and k's ``dk`` (MLA's 128
beside 192; the reference's ``attend_fullseq`` takes that, its Pallas
kernel does not), and the output is ``(..., dv)``.  Two routes, picked
from the type and the dims alone (``kernel.head_dims``): a call at MLA's
(192, 128) goes to the kernels as it is (no pad, no copy, no slice:
bfloat16 to the tensor-core kernel's ``<192, 128>`` instantiation,
float32 to the FP32-core kernel's), and so does any call with ``dk ==
dv`` in :data:`kernel.HEAD_DIMS`.  Any other pair (the smoke config's
(24, 16), a ``dk`` the kernels lack) runs on q, k and v zero-padded
along the head dim to the smallest of :data:`kernel.HEAD_DIMS` at least
``max(dk, dv)`` (:func:`pad_head_dims`), at the unpadded scale, and its
output is sliced back to ``dv``.  That is exact: zero columns add
nothing to q·k, and P·V's padded columns are dropped.  A call no head
dim of the kernel covers raises, and so does a launch the kernel
refuses; nothing falls back to the padded route or the plain version.
The backward recomputes on the unpadded tensors.

Deliberate differences: the reference asserts that its 128-row tiles
divide S and T; the kernel masks partial tiles, so any S and T are
accepted.  ``interpret`` has no meaning here and is not taken; ``scale``
(default ``1/sqrt(dk)``) is.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.launch import LaunchCounter, kernel_scope

__all__ = ["flash_attention", "mha_flash", "flash_attention_ref",
           "pad_head_dims"]

DTYPES = (torch.float32, torch.bfloat16)

#: forward calls that took the plain version (CPU tensors)
plain_forwards = LaunchCounter()
#: backward recomputes through the plain version, on either device
backward_recomputes = LaunchCounter()


def padded_head_dim(dk: int, dv: int, dtype: torch.dtype) -> int:
    """The q/k head dim the kernel runs a ``dtype`` call of q/k head dim
    ``dk`` and v head dim ``dv`` at (``kernel.head_dims``): ``dk`` itself
    where the kernel takes the pair as it is (``dk == dv`` in
    :data:`kernel.HEAD_DIMS`, MLA's (192, 128) in either type), else the
    smallest of :data:`kernel.HEAD_DIMS` at least ``max(dk, dv)`` (32 for
    the smoke config's (24, 16))."""
    return K.head_dims(dtype, dk, dv)[0]


def pad_head_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q and k zero-padded along the head dim (the last) to the q/k head
    dim ``kernel.head_dims`` gives their type and dims, v to its v head
    dim (the tensors themselves where that is no change: on the native
    routes all three)."""
    dk, dv = K.head_dims(q.dtype, q.shape[-1], v.shape[-1])
    return tuple(t if t.shape[-1] == d else F.pad(t, (0, d - t.shape[-1]))
                 for t, d in ((q, dk), (k, dk), (v, dv)))


def _kernel_forward(q, k, v, causal, window, cap, groups, scale):
    """The CUDA route: the kernel on q, k and v as they are or zero-padded
    (:func:`pad_head_dims`), at the scale of the unpadded ``dk``, the
    output sliced back to ``dv`` where it was padded."""
    dk, dv = q.shape[-1], v.shape[-1]
    sc = scale if scale is not None else 1.0 / math.sqrt(dk)
    qp, kp, vp = pad_head_dims(q, k, v)
    out = K.flash_attention_fwd(qp, kp, vp, causal=causal, window=window,
                                cap=cap, scale=sc, groups=groups)
    return out if out.shape[-1] == dv else out[..., :dv]


def _forward(q, k, v, causal, window, cap, groups, scale):
    if q.device.type == "cuda":
        return _kernel_forward(q, k, v, causal, window, cap, groups, scale)
    if q.device.type == "cpu":
        plain_forwards.n += 1
        with kernel_scope("flash_attention"):
            if groups > 1:
                k = k.repeat_interleave(groups, dim=0)
                v = v.repeat_interleave(groups, dim=0)
            return flash_attention_ref(q, k, v, causal=causal,
                                       window=window, cap=cap, scale=scale)
    raise ValueError(f"unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, groups, scale):
        ctx.save_for_backward(q, k, v)
        ctx.conf = (causal, window, cap, groups, scale)
        return _forward(q, k, v, causal, window, cap, groups, scale)

    @staticmethod
    def backward(ctx, g):
        causal, window, cap, groups, scale = ctx.conf
        backward_recomputes.n += 1
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_()
                       for t in ctx.saved_tensors)
            kk, vv = k, v
            if groups > 1:
                kk = k.repeat_interleave(groups, dim=0)
                vv = v.repeat_interleave(groups, dim=0)
            out = flash_attention_ref(q, kk, vv, causal=causal,
                                      window=window, cap=cap, scale=scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, cap: float = 0.0,
                    groups: int = 1, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (BH, S, dk); k: (BH // groups, T, dk); v: (BH // groups, T, dv)
    — heads pre-flattened, KV-major (query head ``b`` reads KV head
    ``b // groups``).  Returns (BH, S, dv) in q's type; differentiable in
    q, k and v."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: float32 "
                        "or bfloat16, one type")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 \
            or v.shape[:2] != k.shape[:2] or k.shape[2] != q.shape[2]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if groups < 1 or q.shape[0] != k.shape[0] * groups:
        raise AssertionError((q.shape[0], k.shape[0], groups))
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 float(cap), int(groups), scale)


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, cap: float = 0.0,
              scale: Optional[float] = None) -> torch.Tensor:
    """(B,S,H,dk) x (B,T,Kv,dk) x (B,T,Kv,dv) GQA wrapper -> (B,S,H,dv).

    The shared KV head is indexed inside the kernel: flat query head
    ``b*H + kv*G + g`` reads KV row ``b*Kv + kv = (b*H + kv*G + g) // G``,
    so the G-fold expansion never exists in device memory in the
    forward."""
    B, S, H, dk = q.shape
    T, Kv, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Kv
    qf = q.transpose(1, 2).reshape(B * H, S, dk)
    kf = k.transpose(1, 2).reshape(B * Kv, T, dk)
    vf = v.transpose(1, 2).reshape(B * Kv, T, dv)
    out = flash_attention(qf, kf, vf, causal, window, cap, G, scale=scale)
    return out.reshape(B, H, S, dv).transpose(1, 2)
