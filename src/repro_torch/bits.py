"""Packed binary codes in torch.

The reference stores bit vectors as uint32 words.  torch's uint32 has too
few operators (no shift on the CPU, no popcount anywhere), so the port
keeps the same 32 bits in an int32 tensor, and counts bits by widening to
int64 and folding with the SWAR steps.  The result is bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch


def words_to_tensor(a, device) -> torch.Tensor:
    """uint32 words (array or tensor) -> int32 tensor holding the same bits."""
    if torch.is_tensor(a):
        if a.dtype == torch.int32:
            return a.to(device)
        a = a.cpu().numpy()
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32, copy=False))
    return torch.from_numpy(a.view(np.int32)).to(device)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit word of an int32 tensor, as int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24
