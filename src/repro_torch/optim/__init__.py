"""Optimizer and quantization primitives of the port (``optim/``):
AdamW with its schedule, and the int8 primitives shared by the quantized
KV pool and the error-feedback gradient compression."""
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update, clip_by_global_norm, cosine_lr,
    init_opt_state,
)
from repro_torch.optim.compress import ef_compress_grads, init_residual

__all__ = ["AdamWConfig", "adamw_update", "clip_by_global_norm",
           "cosine_lr", "init_opt_state", "ef_compress_grads",
           "init_residual"]
