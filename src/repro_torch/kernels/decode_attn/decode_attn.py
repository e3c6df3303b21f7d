"""Single-token GQA decode attention: the CUDA kernel's launcher and its
plain PyTorch version (``repro.kernels.decode_attn.decode_attn`` together
with the per-KV-head mapping of its ``ops.py``).

``decode_attention_kernel`` launches ``csrc/decode_attn.cu`` on CUDA
tensors; ``decode_attention_plain`` computes the same function with torch
ops.  Operands, in the reference's public layout:

    q        [B, H, dh]      float32 or bfloat16; H = KV * G, query head
                             kv * G + g reads KV head kv
    k, v     [B, S, KV, dh]  the cache, same type as q, read in place
    lengths  [B] int32       valid cache length per batch row
    bs       int             positions per online-softmax block

-> [B, H, dh] in q's type.  Both follow the reference's arithmetic block by
block in float32: q scaled first, masked scores -1e30, ``alpha =
exp(m_prev - m_new)``, the final divide by ``max(l, 1e-30)``, S padded with
zero rows to a multiple of ``bs`` (so a row with length 0 averages v over
the padded length).  They sum dot products in other orders, so they agree
to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG = -1e30
MAX_OUT = 2048        # G * dh outputs one block holds (THREADS * MAX_ACC)
SMEM_LIMIT = 232_448  # shared memory one block can use on an H100
SUB = 64              # cache rows the kernel stages at a time


def smem_bytes(G: int, dh: int, bs: int) -> int:
    """Shared memory of one block for G query heads (``decode_attn.cu``'s
    ``smem_bytes``): queries, a block of scores, staged rows, m / l /
    alpha."""
    return 4 * (G * dh + G * bs + SUB * (dh + 1) + 3 * G)


def heads_per_launch(G: int, dh: int, bs: int) -> int:
    """The most query heads of one KV head that a launch takes: G * dh <=
    2,048 outputs per block and ``smem_bytes`` <= 232,448 bytes.  Raises
    where not even one head fits (``smem_bytes(1, dh, bs)`` too large)."""
    fit = (SMEM_LIMIT // 4 - SUB * (dh + 1)) // (dh + bs + 3)
    g = min(G, MAX_OUT // dh, fit)
    if g < 1:
        raise ValueError(
            f"decode_attention kernel: one query head at dh={dh}, bs={bs} "
            f"needs {smem_bytes(1, dh, bs)} bytes of shared memory, above "
            f"the {SMEM_LIMIT} one block can use; pass a smaller bs")
    return g


def decode_attention_plain(q, k, v, lengths, *, bs: int):
    """Plain version of the kernel: the online softmax over blocks of
    ``bs`` cache positions, all KV heads at once, the cache sliced in
    place one block at a time."""
    B, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (dh ** 0.5)
    qg = q.reshape(B, KV, G, dh).to(torch.float32) * scale
    n_blocks = -(-S // bs)
    lens = lengths.to(device=q.device).reshape(B, 1, 1, 1)
    m = torch.full((B, KV, G, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, dh), dtype=torch.float32, device=q.device)
    for j in range(n_blocks):
        s0, s1 = j * bs, min(j * bs + bs, S)
        kb = k[:, s0:s1].to(torch.float32)                 # [B, n, KV, dh]
        vb = v[:, s0:s1].to(torch.float32)
        s = torch.einsum("bhgd,bnhd->bhgn", qg, kb)
        if s1 - s0 < bs:                                   # zero padding rows
            s = torch.nn.functional.pad(s, (0, bs - (s1 - s0)))
        pos = torch.arange(s0, s0 + bs, device=q.device)
        s = torch.where(pos < lens, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgn,bnhd->bhgd",
                                         p[..., :s1 - s0], vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype).reshape(B, H, dh)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"decode_attention kernel: {name} must be a contiguous {dtype} "
            f"tensor of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def decode_attention_kernel(q, k, v, lengths, *, bs: int):
    """Launch the CUDA kernel on CUDA tensors (same contract as
    :func:`decode_attention_plain`).

    Any B (the launcher slices the batch over the grid's limit).  Where a
    KV head's G query heads do not fit one block (G * dh above 2,048
    outputs, or ``smem_bytes(G, dh, bs)`` above 232,448 bytes), they go in
    groups of :func:`heads_per_launch`, one launch each on a contiguous
    copy of the group's queries; every head's arithmetic is the same in
    any group.  The contract: it raises where one head alone needs more
    shared memory than a block has (``smem_bytes(1, dh, bs)`` = 4 (65 dh
    + bs + 67) > 232,448), and on what it does not take (types, shapes,
    devices)."""
    if not q.is_cuda:
        raise ValueError("decode_attention kernel needs CUDA tensors")
    if q.dtype not in DTYPES:
        raise ValueError(f"decode_attention kernel takes float32 or bfloat16,"
                         f" got {q.dtype}")
    dev = q.device
    B, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if B < 1 or S < 1 or KV < 1 or dh < 1 or H % KV or bs < 1:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, bs={bs}")
    G = H // KV
    g = heads_per_launch(G, dh, bs)
    _check("q", q, q.dtype, (B, H, dh), dev)
    _check("k", k, q.dtype, (B, S, KV, dh), dev)
    _check("v", v, q.dtype, (B, S, KV, dh), dev)
    _check("lengths", lengths, torch.int32, (B,), dev)
    out = torch.empty_like(q)
    q4, o4 = q.view(B, KV, G, dh), out.view(B, KV, G, dh)
    for g0 in range(0, G, g):
        g1 = min(G, g0 + g)
        part = q4[:, :, g0:g1].reshape(B, KV * (g1 - g0), dh).contiguous()
        o4[:, :, g0:g1] = _launch(part, k, v, lengths, g1 - g0, bs).view(
            B, KV, g1 - g0, dh)
    return out


def _launch(q, k, v, lengths, G: int, bs: int):
    """One launch of the kernel for q [B, KV * G, dh] (checked operands)."""
    B, _, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), B, S, KV, G, dh, bs,
                    1.0 / (dh ** 0.5), DTYPES[q.dtype], stream)
    kernels.check(status, "decode_attn")
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0

_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        fn = kernels.load("decode_attn").decode_attn_launch
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN
