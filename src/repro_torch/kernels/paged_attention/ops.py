"""Public paged-attention ops (decode + chunked-prefill).

Two API levels, as in ``repro.kernels.paged_attention.ops``:

* ``paged_attention`` / ``paged_prefill`` — host-friendly wrappers over
  separate K/V pools and -1-marked block tables.  They fuse K/V and
  repeat-pad the table per call.
* ``paged_decode_fused`` / ``paged_prefill_fused`` — the entry points for
  callers (the serving engine) that keep the fused ``(P, 2, page, Kv, hd)``
  pool and a repeat-padded block table.

Dispatch is by device: CUDA tensors always go to the hand-written kernel
(``kernel.py``), CPU tensors to the plain version (``ref.py``), reached
through the -1-masked table form it expects.  There is no fallback from
one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.launch import kernel_scope
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_prefill_ref,
)

__all__ = [
    "paged_attention", "paged_prefill", "paged_decode_fused",
    "paged_prefill_fused", "pad_block_table", "page_counts_for",
    "paged_attention_ref", "paged_prefill_ref", "validate_head_sharding",
    "mask_block_table",
]


def validate_head_sharding(num_heads: int, num_kv_heads: int,
                           shards: int) -> int:
    """Check a tensor-parallel head split is GQA-safe for these kernels.

    The kernels' head layout is kv-major: query head ``k*G + g`` reads kv
    head ``k`` (``G = H // Kv``).  A split into ``shards`` equal contiguous
    blocks therefore keeps every query head on the same shard as its kv
    head iff ``shards`` divides ``num_kv_heads``.  Returns the per-shard
    kv-head count; raises ``ValueError`` on an unsafe split.
    """
    if shards < 1:
        raise ValueError(f"head shards must be >= 1, got {shards}")
    if num_heads % max(num_kv_heads, 1):
        raise ValueError(f"H={num_heads} not a multiple of Kv={num_kv_heads}")
    if num_kv_heads % shards:
        raise ValueError(
            f"head axis {shards} does not divide num_kv_heads="
            f"{num_kv_heads}: a shard would split a GQA group across "
            f"devices and the block-table gather could not stay local")
    return num_kv_heads // shards


def page_counts_for(lengths, page_size: int):
    """(B,) number of mapped logical pages implied by token counts (also
    works on a Python int)."""
    return (lengths + page_size - 1) // page_size


def pad_block_table(block_table: torch.Tensor,
                    page_counts: torch.Tensor) -> torch.Tensor:
    """-1-marked (B, n_pages) table -> the repeat-padded form the kernel
    wants: entries past ``page_counts[b]`` repeat the last mapped page.

    Contract: mapping must be *dense* — every logical page below
    ``page_counts[b]`` mapped (>= 0), -1 only past the mapped prefix (what
    ``PagedKVPool`` produces).  An interior -1 hole would be remapped to
    physical page 0 here, where the masked plain version would exclude it.
    """
    n_pages = block_table.shape[1]
    idx = torch.arange(n_pages, dtype=torch.int32,
                       device=block_table.device)[None, :]
    last = (page_counts - 1).clamp(min=0).to(torch.int32)[:, None]
    return torch.gather(block_table.clamp(min=0), 1,
                        torch.minimum(idx, last).long()).to(torch.int32)


def mask_block_table(block_table: torch.Tensor,
                     page_counts: torch.Tensor) -> torch.Tensor:
    """Repeat-padded table -> the -1-marked form the plain version reads
    (entries at or past ``page_counts[b]`` become -1)."""
    idx = torch.arange(block_table.shape[1], dtype=torch.int32,
                       device=block_table.device)[None, :]
    return torch.where(idx < page_counts[:, None], block_table,
                       torch.full_like(block_table, -1))


def _scales(kv_scales):
    """(P, 2, Kv) scales -> the plain version's (k_scales, v_scales)."""
    if kv_scales is None:
        return {}
    return dict(k_scales=kv_scales[:, 0], v_scales=kv_scales[:, 1])


def paged_decode_fused(q, kv_pages, block_table, page_counts, lengths, *,
                       pages_per_step: int = 2, kv_scales=None):
    """Decode on a fused pool + repeat-padded block table.  q: (B,H,hd);
    returns (B,H,hd).  Pass ``kv_scales`` ((P, 2, Kv) float32) for an int8
    pool: the pages are dequantized in the K/V fetch."""
    if q.is_cuda:
        return K.paged_decode_fwd(q, kv_pages, block_table, page_counts,
                                  lengths, pages_per_step=pages_per_step,
                                  kv_scales=kv_scales)
    with kernel_scope("paged_decode"):
        return paged_attention_ref(
            q, kv_pages[:, 0], kv_pages[:, 1],
            mask_block_table(block_table, page_counts), lengths,
            **_scales(kv_scales))


def paged_prefill_fused(q, kv_pages, block_table, page_counts, lengths,
                        q_start, *, pages_per_step: int = 2, kv_scales=None):
    """Chunked prefill on a fused pool + repeat-padded block table.
    q: (B,C,H,hd); returns (B,C,H,hd).  ``kv_scales`` as in
    :func:`paged_decode_fused`."""
    if q.is_cuda:
        return K.paged_prefill_fwd(q, kv_pages, block_table, page_counts,
                                   lengths, q_start,
                                   pages_per_step=pages_per_step,
                                   kv_scales=kv_scales)
    with kernel_scope("paged_prefill"):
        return paged_prefill_ref(
            q, kv_pages[:, 0], kv_pages[:, 1],
            mask_block_table(block_table, page_counts), lengths, q_start,
            **_scales(kv_scales))


def paged_attention(q, k_pages, v_pages, block_table, lengths, *,
                    pages_per_step: int = 2):
    """Decode, host-friendly form.

    q: (B,H,hd); k/v_pages: (P, page, Kv, hd); block_table: (B, max_pages)
    int32 physical page ids, densely mapped for the first
    ``ceil(length/page)`` logical pages and -1 past them; lengths: (B,)
    int32.  Returns (B,H,hd).
    """
    counts = page_counts_for(lengths, k_pages.shape[1])
    return paged_decode_fused(
        q, torch.stack([k_pages, v_pages], dim=1),
        pad_block_table(block_table, counts), counts, lengths,
        pages_per_step=pages_per_step)


def paged_prefill(q, k_pages, v_pages, block_table, lengths, q_start, *,
                  pages_per_step: int = 2):
    """Chunked prefill, host-friendly form.

    q: (B,C,H,hd) — C chunk tokens at positions q_start..q_start+C-1, whose
    K/V are already in the pool; other args as ``paged_attention``.
    """
    counts = page_counts_for(lengths, k_pages.shape[1])
    return paged_prefill_fused(
        q, torch.stack([k_pages, v_pages], dim=1),
        pad_block_table(block_table, counts), counts, lengths, q_start,
        pages_per_step=pages_per_step)
