"""Single-token GQA decode attention: the CUDA kernel's launcher and its
plain PyTorch version (``repro.kernels.decode_attn.decode_attn`` together
with the per-KV-head mapping of its ``ops.py``).

``decode_attention_kernel`` launches ``csrc/decode_attn.cu`` on CUDA
tensors; ``decode_attention_plain`` computes the same function with torch
ops.  The kernel runs in two passes: a partition pass splits the cache
into P partitions of ``part_blocks`` whole blocks of ``bs`` positions
(:func:`partitions` picks P from the shapes and the card) and writes each
(KV head, batch row, partition)'s float32 partial (m, l, acc) to a
workspace the wrapper allocates ([P, B, H] for m and l, [P, B, H, dh] for
acc); a combine pass merges the partials in ascending partition order and
divides.  Operands, in the reference's public layout:

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
to float32 rounding, not bit for bit.  The plain version with
``part_blocks`` runs the kernel's partitions and combine in the kernel's
order; without it, the blocks in one sequence, as the reference does.
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
SLICE = 65_535        # batch rows of one launch (grid.y's limit)
# Resident waves of partition blocks a launch aims for, so that the last,
# partly filled wave is a small share of the work.  Swept over 1, 2, 3, 4,
# 6, 8 and 16 on an H100 (bf16, bs = 512): 16 was fastest at decode_32k
# (B = 128, KV = 8) and at long_500k with B = 1 and S // 3 + 1 valid
# positions, and about level with the fastest (6) at long_500k full.
WAVES = 16


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


def partitions(B: int, KV: int, bs: int, S: int, n_sm: int,
               per_sm: int) -> tuple:
    """(part_blocks, P) for one launch.  P' is the fewest partitions that
    make the blocks of one batch slice (``min(B, 65,535) * KV * P'``) at
    least ``WAVES`` resident waves of ``n_sm * per_sm`` blocks, at most
    n_blocks; the partitions are runs of part_blocks = ceil(n_blocks / P')
    whole ``bs``-blocks, so P <= P' and, where P' < n_blocks, P > P' / 2.
    P = 1 where the (KV head, row) pairs already fill the waves.  From
    shapes and the card only (the lengths would have to be read to the
    host)."""
    n_blocks = -(-S // bs)
    pairs = min(B, SLICE) * KV
    P = min(n_blocks, max(1, -(-WAVES * n_sm * per_sm // pairs)))
    part_blocks = -(-n_blocks // P)
    return part_blocks, -(-n_blocks // part_blocks)


def _online(qg, k, v, lens, s0, s1, bs):
    """The online softmax over positions [s0, s1) in blocks of ``bs``
    from m = -1e30, l = 0, acc = 0: (m, l [B, KV, G, 1], acc [B, KV, G,
    dh]) in float32."""
    B, KV, G, dh = qg.shape
    S = k.shape[1]
    m = torch.full((B, KV, G, 1), NEG, dtype=torch.float32, device=qg.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, dh), dtype=torch.float32, device=qg.device)
    for b0 in range(s0, s1, bs):
        b1 = min(b0 + bs, S)
        kb = k[:, b0:b1].to(torch.float32)                 # [B, n, KV, dh]
        vb = v[:, b0:b1].to(torch.float32)
        s = torch.einsum("bhgd,bnhd->bhgn", qg, kb)
        if b1 - b0 < bs:                                   # zero padding rows
            s = torch.nn.functional.pad(s, (0, bs - (b1 - b0)))
        pos = torch.arange(b0, b0 + bs, device=qg.device)
        s = torch.where(pos < lens, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgn,bnhd->bhgd",
                                         p[..., :b1 - b0], vb)
        m = m_new
    return m, l, acc


def decode_attention_plain(q, k, v, lengths, *, bs: int,
                           part_blocks: int | None = None):
    """Plain version of the kernel: the online softmax over blocks of
    ``bs`` cache positions, all KV heads at once, the cache sliced in
    place one block at a time.  ``part_blocks=None`` runs the blocks in
    one sequence; an int runs the kernel's partitions of that many blocks
    and its combine, partitions in ascending order.  A partition past a
    positive length gives (m = -1e30, l, acc) here where the kernel writes
    (-1e30, 0, 0): the combine weighs both by exp(-1e30 - M) = 0."""
    B, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    scale = 1.0 / (dh ** 0.5)
    qg = q.reshape(B, KV, H // KV, dh).to(torch.float32) * scale
    lens = lengths.to(device=q.device).reshape(B, 1, 1, 1)
    n_blocks = -(-S // bs)
    if part_blocks is None:
        m, l, acc = _online(qg, k, v, lens, 0, n_blocks * bs, bs)
        out = acc / torch.clamp_min(l, 1e-30)
    else:
        span = part_blocks * bs
        parts = [_online(qg, k, v, lens, s0, min(s0 + span, n_blocks * bs),
                         bs) for s0 in range(0, n_blocks * bs, span)]
        top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        num = torch.zeros_like(parts[0][2])
        den = torch.zeros_like(top)
        for m, l, acc in parts:
            w = torch.exp(m - top)
            num = num + w * acc
            den = den + w * l
        out = num / torch.clamp_min(den, 1e-30)
    return out.to(q.dtype).reshape(B, H, dh)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"decode_attention kernel: {name} must be a contiguous {dtype} "
            f"tensor of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def kernel_partitions(q, k, bs: int) -> tuple:
    """(part_blocks, P) the kernel takes for these operands: P from
    :func:`partitions`, with the card's SM count and the partition pass's
    resident blocks per SM at :func:`heads_per_launch`'s group size.  All
    groups of query heads take the same partitions."""
    B, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = heads_per_launch(H // KV, dh, bs)
    key = (q.device.index, g, dh, bs, q.dtype)
    if key not in _PER_SM:
        out = ctypes.c_int(0)
        with torch.cuda.device(q.device):
            status = _fns()[1](g, dh, bs, DTYPES[q.dtype],
                               ctypes.byref(out))
        kernels.check(status, "decode_attn occupancy")
        _PER_SM[key] = out.value
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    return partitions(B, KV, bs, S, n_sm, _PER_SM[key])


def decode_attention_kernel(q, k, v, lengths, *, bs: int,
                            part_blocks: int | None = None):
    """Launch the CUDA kernel on CUDA tensors (same contract as
    :func:`decode_attention_plain`).

    Each launch is a pair: the partition pass and the combine pass, on the
    current stream, through a float32 workspace of P (B H (dh + 2)) words
    allocated here; ``launches`` counts one per pair.  ``part_blocks``
    (1 to n_blocks) fixes the partitions; None takes
    :func:`kernel_partitions`' choice.  Any B (the launcher slices the
    batch over the grid's limit).  Where a KV head's G query heads do not
    fit one block (G * dh above 2,048 outputs, or ``smem_bytes(G, dh,
    bs)`` above 232,448 bytes), they go in groups of
    :func:`heads_per_launch`, one pair each on a contiguous copy of the
    group's queries; every head's arithmetic is the same in any group.
    The contract: it raises where one head alone needs more shared memory
    than a block has (``smem_bytes(1, dh, bs)`` = 4 (65 dh + bs + 67) >
    232,448), and on what it does not take (types, shapes, devices,
    ``part_blocks`` out of range)."""
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
    n_blocks = -(-S // bs)
    if part_blocks is None:
        part_blocks = kernel_partitions(q, k, bs)[0]
    if not 1 <= part_blocks <= n_blocks:
        raise ValueError(f"part_blocks={part_blocks} is outside [1, "
                         f"{n_blocks}] blocks of {bs} positions")
    out = torch.empty_like(q)
    q4, o4 = q.view(B, KV, G, dh), out.view(B, KV, G, dh)
    for g0 in range(0, G, g):
        g1 = min(G, g0 + g)
        part = q4[:, :, g0:g1].reshape(B, KV * (g1 - g0), dh).contiguous()
        o4[:, :, g0:g1] = _launch(part, k, v, lengths, g1 - g0, bs,
                                  part_blocks).view(B, KV, g1 - g0, dh)
    return out


def _launch(q, k, v, lengths, G: int, bs: int, part_blocks: int):
    """One pair of passes for q [B, KV * G, dh] (checked operands)."""
    B, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    n_blocks = -(-S // bs)
    n = -(-n_blocks // part_blocks) * B * H           # P * B * H partials
    out = torch.empty_like(q)
    ws = torch.empty(n * (dh + 2), dtype=torch.float32, device=q.device)
    acc, m, l = ws.data_ptr(), ws[n * dh:].data_ptr(), \
        ws[n * (dh + 1):].data_ptr()
    launch, _ = _fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lengths.data_ptr(), out.data_ptr(), m, l, acc, B, S,
                        KV, G, dh, bs, part_blocks, 1.0 / (dh ** 0.5),
                        DTYPES[q.dtype], stream)
    kernels.check(status, "decode_attn")
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0

_FNS = None
_PER_SM = {}


def _fns():
    """The library's (decode_attn_launch, decode_attn_blocks_per_sm)."""
    global _FNS
    if _FNS is None:
        lib = kernels.load("decode_attn")
        p, i = ctypes.c_void_p, ctypes.c_int
        launch, occ = lib.decode_attn_launch, lib.decode_attn_blocks_per_sm
        launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                           ctypes.c_float, i, p]
        occ.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        launch.restype = occ.restype = i
        _FNS = launch, occ
    return _FNS
