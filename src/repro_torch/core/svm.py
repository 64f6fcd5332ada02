"""SVM — shared "virtual memory" between host and accelerator (HERO §2.2).

Ported from ``repro.core.svm``.  HERO's SVM lets host and PMCA exchange
*pointers* instead of copies; the host RTE reserves virtual ranges that
would collide with the PMCA's own address map (§2.2.3).  Here a handle
resolves to a device-resident ``torch.Tensor``; passing a handle is
zero-copy.  Reserved ranges model the PMCA SPM/register apertures that
must never be used for shared data.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch


class AddressCollision(Exception):
    pass


class SVMSpace:
    """Handle registry: logical id -> device tensor (+ reserved apertures)."""

    def __init__(self, reserved: Iterable[Tuple[int, int]] = ((0, 1 << 20),)):
        # reserved (lo, hi) handle ranges = PMCA-internal apertures (§2.2.3)
        self.reserved = tuple(reserved)
        self.buffers: Dict[int, torch.Tensor] = {}
        self._next = max(hi for _, hi in self.reserved) if self.reserved else 1

    def _check(self, handle: int):
        for lo, hi in self.reserved:
            if lo <= handle < hi:
                raise AddressCollision(
                    f"handle {handle:#x} falls in reserved aperture "
                    f"[{lo:#x},{hi:#x}) — would be routed to PMCA-internal "
                    f"memory, not SVM")

    def share(self, array: torch.Tensor, handle: Optional[int] = None) -> int:
        """Publish a device tensor; returns its handle (the 'pointer')."""
        if handle is None:
            handle = self._next
            self._next += 1
        self._check(handle)
        if handle in self.buffers:
            raise AddressCollision(f"handle {handle:#x} already mapped")
        self.buffers[handle] = array
        return handle

    def deref(self, handle: int) -> torch.Tensor:
        return self.buffers[handle]

    def update(self, handle: int, array: torch.Tensor):
        assert handle in self.buffers
        self.buffers[handle] = array

    def release(self, handle: int):
        self.buffers.pop(handle, None)

    def __contains__(self, handle: int) -> bool:
        return handle in self.buffers
