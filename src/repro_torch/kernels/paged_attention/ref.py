"""Plain-PyTorch paged attention: gather pages, dense attend in float32.

The port of ``repro.kernels.paged_attention.ref``: bf16/f32 pools, and
int8 pools with ``k_scales``/``v_scales`` ((P, Kv) float32, one per page
and kv head) applied to the gathered pages before the math.  It is the
CUDA kernel's plain version: the CPU tests hold it against the JAX oracle,
and ``chip_smoke.py`` holds the kernel against it on the card.  Block
tables are -1-marked: a negative entry masks that logical page.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.launch import LaunchCounter

NEG_INF = -1e30

#: calls of the plain version (``chip_smoke.py`` checks that the serving
#: path on the card never reaches it)
calls = LaunchCounter()


def _gather(k_pages, v_pages, block_table, k_scales=None, v_scales=None):
    """(B, n_pages*page, Kv, hd) dense K/V in float32 (int8 pages
    dequantized by their scales), and the per-token page-mapped mask
    (B, T)."""
    B, n_pages = block_table.shape
    _, page, Kv, hd = k_pages.shape
    safe = block_table.clamp(min=0).long()
    k = k_pages[safe].float()
    v = v_pages[safe].float()
    if k_scales is not None:
        k = k * k_scales[safe][:, :, None, :, None]
        v = v * v_scales[safe][:, :, None, :, None]
    k = k.reshape(B, n_pages * page, Kv, hd)
    v = v.reshape(B, n_pages * page, Kv, hd)
    page_ok = (block_table >= 0).repeat_interleave(page, dim=1)
    return k, v, page_ok


def paged_prefill_ref(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_table: torch.Tensor,
                      lengths: torch.Tensor, q_start: torch.Tensor, *,
                      scale: Optional[float] = None,
                      k_scales: Optional[torch.Tensor] = None,
                      v_scales: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Chunked prefill: q (B,C,H,hd) at positions q_start..q_start+C-1;
    k/v_pages (P, page, Kv, hd); block_table (B, n_pages) -1-marked;
    lengths (B,) include the chunk's pool-resident tokens.  Mask
    ``tok < len & tok <= qpos``; fully masked rows are 0.  GQA is
    kv-major (query head ``k*G+g`` reads kv head ``k``).  ``k_scales`` /
    ``v_scales`` ((P, Kv) float32) mark the pages int8.  Returns
    (B,C,H,hd) in ``q.dtype``."""
    calls.n += 1
    B, C, H, hd = q.shape
    Kv = k_pages.shape[2]
    G = H // Kv
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    k, v, page_ok = _gather(k_pages, v_pages, block_table, k_scales,
                            v_scales)
    T = k.shape[1]
    qg = q.float().reshape(B, C, Kv, G, hd)
    s = torch.einsum("bckgh,btkh->bckgt", qg, k) * sc
    tok = torch.arange(T, device=q.device)[None, None, :]          # (1,1,T)
    qpos = (q_start[:, None] + torch.arange(C, device=q.device)[None, :]
            )[..., None]                                            # (B,C,1)
    mask = (tok < lengths[:, None, None]) & (tok <= qpos)           # (B,C,T)
    mask = (mask & page_ok[:, None, :])[:, :, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    out = torch.einsum("bckgt,btkh->bckgh", p, v)
    return out.reshape(B, C, H, hd).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        lengths: torch.Tensor, *,
                        scale: Optional[float] = None,
                        k_scales: Optional[torch.Tensor] = None,
                        v_scales: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Decode: q (B,H,hd), one query per lane at position ``len - 1`` —
    the C=1 case of :func:`paged_prefill_ref` (the masks coincide, and an
    empty lane, qpos = -1, stays fully masked).  Returns (B,H,hd)."""
    return paged_prefill_ref(q[:, None], k_pages, v_pages, block_table,
                             lengths, lengths - 1, scale=scale,
                             k_scales=k_scales, v_scales=v_scales)[:, 0]
