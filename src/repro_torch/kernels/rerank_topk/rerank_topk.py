"""Fused candidate rerank: the CUDA kernel's launcher and its plain PyTorch
version (``repro.kernels.rerank_topk.rerank_topk``).

``rerank_topk_kernel`` launches ``csrc/rerank_topk.cu`` on CUDA tensors;
``rerank_topk_plain`` computes the same function with torch ops, candidate
block by candidate block, in the reference's arithmetic.  Operands, as the
TPU kernel takes them:

    cand_rows [b, C] int32   corpus rows to gather (clamped >= 0)
    Q         [b, d]         float32, or int32 words (the uint32 bits) for ham
    qsq       [b]    float32 squared query norms (l2sq; zeros otherwise)
    cand_ids  [b, C] int32   output id per slot, -1 where masked
    pen       [b, C] float32 cached |x|^2 (l2sq) or 0, +inf where masked
    X         [n, d]         float32, or int32 words for ham

-> ([b, k] float32, [b, k] int32): the k best distinct ids by (dist, id).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.bits import popcount32

NEG_ONE = -1
MODES = {"l2sq": 0, "cos": 1, "ham": 2}


def merge_topk_unique_rounds(cand_d: torch.Tensor, cand_i: torch.Tensor,
                             k: int):
    """k smallest (dist, id) pairs per row with duplicate ids removed.

    The reference runs k rounds of (min distance, smallest id among its
    ties, retire every copy of that id).  That is the canonical
    ``topk_unique`` select: each id at its smallest distance, ordered by
    (dist, id), padded with (+inf, -1).  Invalid candidates must carry
    (+inf, -1), as the wrappers guarantee.
    """
    from repro_torch.ann.topk import topk_unique   # deferred: import cycle

    vals, ids = topk_unique(cand_d, cand_i, k)
    alive = torch.isfinite(vals)
    return vals, torch.where(alive, ids, torch.full_like(ids, NEG_ONE))


def _block_distances(Q, X, qsq, rows, pen, mode: str):
    x = X[rows.long()]                                      # [b, c, d]
    if mode == "ham":
        xor = torch.bitwise_xor(x, Q[:, None, :])
        return popcount32(xor).sum(dim=-1).to(torch.float32) + pen
    cross = torch.einsum("bcd,bd->bc", x, Q)
    if mode == "l2sq":
        return (qsq[:, None] - 2.0 * cross) + pen
    return (1.0 - cross) + pen


def rerank_topk_plain(cand_rows, Q, qsq, cand_ids, pen, X, *, mode: str,
                      k: int, bc: int = 1024, bq: int = 256):
    """Plain version of the kernel: queries in blocks of ``bq``, candidates
    in blocks of ``bc`` gathered and scored, each folded into the running
    state through ``merge_topk_unique_rounds``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    b, C = cand_rows.shape
    outs_d, outs_i = [], []
    for q0 in range(0, b, bq):
        q1 = min(q0 + bq, b)
        vals = torch.full((q1 - q0, k), float("inf"), dtype=torch.float32,
                          device=X.device)
        ids = torch.full((q1 - q0, k), NEG_ONE, dtype=torch.int32,
                         device=X.device)
        for s in range(0, C, bc):
            e = min(s + bc, C)
            d = _block_distances(Q[q0:q1], X, qsq[q0:q1],
                                 cand_rows[q0:q1, s:e], pen[q0:q1, s:e], mode)
            vals, ids = merge_topk_unique_rounds(
                torch.cat([vals, d], dim=1),
                torch.cat([ids, cand_ids[q0:q1, s:e]], dim=1), k)
        outs_d.append(vals)
        outs_i.append(ids)
    return torch.cat(outs_d), torch.cat(outs_i)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"rerank_topk kernel: {name} must be a contiguous {dtype} tensor "
            f"of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def rerank_topk_kernel(cand_rows, Q, qsq, cand_ids, pen, X, *, mode: str,
                       k: int):
    """Launch the CUDA kernel on CUDA tensors (same contract as
    :func:`rerank_topk_plain`).  Raises on anything it does not take."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not 1 <= k <= kernels.MAX_K:
        raise ValueError(f"rerank_topk kernel takes 1 <= k <= "
                         f"{kernels.MAX_K}, got k={k}")
    if not X.is_cuda:
        raise ValueError("rerank_topk kernel needs CUDA tensors")
    dev = X.device
    b, C = cand_rows.shape
    n, d = X.shape
    if b < 1 or C < 1 or n < 1 or d < 1:
        raise ValueError(f"empty operand: b={b}, C={C}, n={n}, d={d}")
    word = torch.int32 if mode == "ham" else torch.float32
    _check("cand_rows", cand_rows, torch.int32, (b, C), dev)
    _check("Q", Q, word, (b, d), dev)
    _check("qsq", qsq, torch.float32, (b,), dev)
    _check("cand_ids", cand_ids, torch.int32, (b, C), dev)
    _check("pen", pen, torch.float32, (b, C), dev)
    _check("X", X, word, (n, d), dev)
    if X.data_ptr() % 16:
        raise ValueError("rerank_topk kernel: X must be 16-byte aligned")
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    fn = _launch_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(cand_rows.data_ptr(), Q.data_ptr(), qsq.data_ptr(),
                    cand_ids.data_ptr(), pen.data_ptr(), X.data_ptr(),
                    out_d.data_ptr(), out_i.data_ptr(), b, C, d, k,
                    MODES[mode], stream)
    kernels.check(status, "rerank_topk")
    rerank_topk_kernel.launches += 1
    return out_d, out_i


rerank_topk_kernel.launches = 0

_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        fn = kernels.load("rerank_topk").rerank_topk_launch
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN
