"""The part of ``jax.random`` the serving engine's sampler uses, in PyTorch.

A bit-exact copy of JAX's default PRNG as the reference engine draws from
it (``jax_threefry_partitionable`` on, the default since JAX 0.5):

* :func:`threefry2x32` — the Threefry-2x32 block cipher, 20 rounds with
  the rotations and key injections of ``jax._src.prng``;
* :func:`prng_key` — ``jax.random.PRNGKey(seed)`` for a 32-bit seed:
  ``[0, seed]``;
* :func:`fold_in` — ``jax.random.fold_in``: the cipher of the count pair
  ``(0, data)``;
* :func:`random_bits` — 32-bit draws in partitionable mode: element ``i``
  is the cipher of the 64-bit count ``i`` split into its (hi, lo) words,
  its two output words XOR-ed;
* :func:`uniform`, :func:`gumbel` (mode "low") and :func:`categorical`
  (the Gumbel-max trick) on top of them, in float32.

Torch has no unsigned 32-bit arithmetic it can rely on, so every word is
held in an ``int64`` tensor and masked to 32 bits after each add and each
rotate.  Everything up to the float bitcast is integer work, so keys,
bits and uniforms are equal bit for bit on every device; the logarithms of
:func:`gumbel` follow the device's ``log``.

Keys are ``(..., 2)`` int64 tensors, batched over their leading dims (the
engine's lanes); each key's counts run ``0 .. n-1``, as under the
reference's ``vmap``.
"""
from __future__ import annotations

import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits", "uniform",
           "gumbel", "categorical"]

_MASK = 0xFFFFFFFF
#: the two rotation schedules, alternating every four rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: Threefry's key-schedule parity constant
_PARITY = 0x1BD11BDA
#: float32's smallest normal number, gumbel's lower bound for its uniforms
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """Threefry-2x32 of the count words ``(x1, x2)`` under the key
    ``(k1, k2)``: int64 tensors holding 32-bit words, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``PRNGKey(seed)`` for each 32-bit seed of ``seed``: (..., 2) int64,
    ``[0, seed & 0xFFFFFFFF]``."""
    seed = seed.to(torch.int64) & _MASK
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fold_in(key, data)`` for (..., 2) keys and data broadcast to their
    leading dims (taken modulo 2**32, as the reference's uint32 cast)."""
    data = data.to(torch.int64) & _MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) int64 holding 32-bit draws: ``jax.random.bits(key, (n,))``
    for each key, in partitionable mode."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """(..., n) float32 in [minval, maxval): the top 23 bits of each draw
    as the mantissa of a float in [1, 2), minus 1, scaled by the float32
    span and shifted with one rounding (XLA fuses the two into a
    multiply-add; float64 holds the 47-bit product exactly), then raised
    to ``minval`` (``jax.random.uniform``)."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.float())


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) float32 standard Gumbel draws, ``jax.random.gumbel`` in
    mode "low": ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of (..., V) ``logits`` (``jax.random.categorical``
    on the last axis): the argmax of the logits plus Gumbel noise."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
