from repro_torch.kernels.paged_attention.ops import (
    paged_attention, paged_prefill, paged_decode_fused, paged_prefill_fused,
    pad_block_table, page_counts_for, mask_block_table,
    validate_head_sharding,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_prefill_ref,
)

__all__ = ["paged_attention", "paged_prefill", "paged_decode_fused",
           "paged_prefill_fused", "pad_block_table", "page_counts_for",
           "mask_block_table", "validate_head_sharding",
           "paged_attention_ref", "paged_prefill_ref"]
