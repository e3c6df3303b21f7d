"""Plain torch oracle for decode attention
(``repro.kernels.decode_attn.ref``): the whole score row at once."""

from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, lengths):
    """q [B, G, dh], k/v [B, S, dh], lengths [B] -> [B, G, dh]."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bgd,bsd->bgs", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    pos = torch.arange(k.shape[1], device=k.device)
    mask = pos[None, None, :] < lengths.to(k.device)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - torch.max(s, dim=-1, keepdim=True).values)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bgs,bsd->bgd", p,
                        v.to(torch.float32)).to(q.dtype)
