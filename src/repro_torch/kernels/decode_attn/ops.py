"""Public wrapper: multi-KV-head GQA decode attention
(``repro.kernels.decode_attn.ops``).

``decode_attention(q [B, H, dh], k/v [B, S, KV, dh], lengths)``: the
reference vmaps its per-KV-head kernel over axis 2 of the cache, after
padding S to a multiple of ``bs``; here the kernel regroups the H = KV * G
query heads itself and reads the cache in place (no per-head copy, no
padded copy: the padding rows are zeros the kernel supplies).  CUDA
tensors go to the kernel (``decode_attention_kernel``), CPU tensors to its
plain version.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels.decode_attn.decode_attn import (
    decode_attention_kernel, decode_attention_plain)


def decode_attention(q, k, v, lengths=None, *, bs: int = 512, device=None):
    """[B, H, dh] attention of one query token per head over the cache,
    in q's type.  A tensor ``k`` fixes the device; arrays go to ``device``
    (``cuda`` unless the caller asks for ``cpu``)."""
    dev = k.device if torch.is_tensor(k) else resolve_device(device)
    k = torch.as_tensor(k).to(dev)
    q = torch.as_tensor(q).to(device=dev, dtype=k.dtype).contiguous()
    v = torch.as_tensor(v).to(device=dev, dtype=k.dtype)
    B, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    lengths = torch.as_tensor(lengths).to(device=dev, dtype=torch.int32)
    bs = min(bs, S)
    fn = decode_attention_kernel if q.is_cuda else decode_attention_plain
    return fn(q, k.contiguous(), v.contiguous(), lengths.contiguous(), bs=bs)
