"""Blocked attention with online softmax (``repro.models.flash``), in
plain torch.

The reference computes this in jnp, outside any Pallas kernel: an outer
map over query blocks and an inner scan over KV blocks keep only a
(bq, bk) tile of scores live.  The port loops over the same blocks with
the same online softmax, in fp32, so its accumulation is the reference's
(``scaled_dot_product_attention`` has no softcap and sums another way).

Supports GQA grouping, causal masking, sliding windows, and logit
softcap; ``block_skip`` scans each query block's reachable KV blocks
only, with the same result.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30


def flash_attention(
    q: torch.Tensor,           # [B, S, KV, G, dh]
    k: torch.Tensor,           # [B, T, KV, dh]
    v: torch.Tensor,           # [B, T, KV, dv]
    q_pos: torch.Tensor,       # [S]
    k_pos: torch.Tensor,       # [T]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: float = 0.0,
    bq: int = 512,
    bk: int = 1024,
    block_skip: bool = False,
) -> torch.Tensor:
    """Returns [B, S, KV, G, dv] attention output in q's dtype."""
    B, S, KV, G, dh = q.shape
    T = k.shape[1]
    dv = v.shape[-1]
    bq = pick_block(S, bq)
    bk = pick_block(T, bk)
    nq, nk = S // bq, T // bk
    scale = dh ** -0.5

    qb = q.reshape(B, nq, bq, KV, G, dh).permute(1, 0, 3, 4, 2, 5)
    # qb [nq, B, KV, G, bq, dh]
    kb = k.reshape(B, nk, bk, KV, dh).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nk, bk, KV, dv).permute(1, 0, 3, 2, 4)
    # kb/vb [nk, B, KV, bk, dh]
    qpb = q_pos.reshape(nq, bq)
    kpb = k_pos.reshape(nk, bk)

    def q_block(qi, qp, lo, hi):
        qf = qi.to(torch.float32)
        m = torch.full((B, KV, G, bq, 1), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, bq, 1), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, KV, G, bq, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(lo, hi):
            kp = kpb[j]
            s = torch.einsum("bKgqd,bKkd->bKgqk", qf,
                             kb[j].to(torch.float32)) * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            mask = torch.ones((bq, bk), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kp[None, :] <= qp[:, None]
            if window is not None:
                mask &= kp[None, :] > qp[:, None] - window
            s = s.masked_fill(~mask[None, None, None, :, :], _NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bKgqk,bKkd->bKgqd", p, vb[j].to(torch.float32))
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)
        return out.to(q.dtype)                     # [B,KV,G,bq,dv]

    blocks = []
    for i in range(nq):
        if not block_skip:
            # every q block scans every kv block
            lo, hi = 0, nk
        else:
            # causal/window block skipping: each q block scans only the kv
            # blocks its mask can reach
            q_lo = i * bq
            q_hi = q_lo + bq - 1
            hi = (q_hi // bk) + 1 if causal else nk
            lo = max(0, (q_lo - window) // bk) if window else 0
            hi = min(max(hi, lo + 1), nk)
        blocks.append(q_block(qb[i], qpb[i], lo, hi))
    outs = torch.stack(blocks)
    # outs [nq, B, KV, G, bq, dv] -> [B, S, KV, G, dv]
    return outs.permute(1, 0, 4, 2, 3, 5).reshape(B, S, KV, G, dv)


def pick_block(size: int, target: int) -> int:
    """Largest divisor of ``size`` that is <= target (block shapes must
    tile the sequence exactly)."""
    b = min(target, size)
    while size % b != 0:
        b -= 1
    return b
