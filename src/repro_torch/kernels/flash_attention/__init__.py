from repro_torch.kernels.flash_attention.ops import flash_attention, mha_flash
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention", "mha_flash", "flash_attention_ref"]
