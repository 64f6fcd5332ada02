"""Device resolution shared by the port's entry points.

The port runs on the CUDA device by default.  A caller that wants the CPU
says so (``device="cpu"``, as the CPU tests do); without a GPU, asking for
the default raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and none
    is available.  A CUDA device comes back with its index, so it compares
    equal to the device of a tensor that lives on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
