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
# Bound on a float output's error against the exact value of its
# expression, relative to the weight of the cross term in it
# (``err_vs_exact``).  A chain of fmaf over d words errs by at most
# d * 2^-24 of that weight (7.6e-6 at d = 128), and in practice by a few
# times sqrt(d) * 2^-24; operands rounded to TF32 (10-bit mantissas) or
# one term of the sum dropped err by far more.  test_torch_rerank_lists.py
# holds all three at d = 128; PERF.md gives the kernel's readings.
EXACT_REL = 4e-6


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


def _cross(x, Q):
    """<q, x> of [b, c, d] rows against [b, d] queries, summed over d in
    index order from +0.0, as the kernel's fmaf chain does (torch may round
    each product before its add: a few units in the last place apart at
    these widths, where another order, an einsum's, differs by more)."""
    xt = x.permute(2, 0, 1).contiguous()                    # [d, b, c]
    acc = torch.zeros(xt.shape[1:], dtype=torch.float32, device=x.device)
    for j in range(xt.shape[0]):
        acc = torch.addcmul(acc, xt[j], Q[:, j:j + 1])
    return acc


def err_vs_exact(out, cand_rows, Q, qsq, cand_ids, pen, X, *, mode: str,
                 k=None):
    """(largest |dist - exact|, largest |dist - exact| / w) over the
    filled slots of ``out``, a rerank result on this window (l2sq or
    cos): exact is the kernel's expression on its fp32 operands with the
    cross term in fp64, whatever the order of the sums, and w = c * sum_j
    |q_j x_j| is the cross term's weight in it (c = 2 for l2sq, 1 for
    cos).  Each output id must stand for one row of the window, as it
    does without an id map."""
    if mode not in ("l2sq", "cos"):
        raise ValueError(f"err_vs_exact takes l2sq or cos, not {mode!r}")
    d, i = out
    fin = i >= 0
    if not bool(fin.any()):
        return 0.0, 0.0
    valid = (cand_ids >= 0) & torch.isfinite(pen)
    vid = cand_ids[valid].long()
    size = int(max(int(vid.max()), int(i.max()))) + 1
    row_of = torch.full((size,), -1, dtype=torch.long, device=X.device)
    pen_of = torch.zeros(size, dtype=torch.float64, device=X.device)
    row_of[vid] = cand_rows[valid].long()
    pen_of[vid] = pen[valid].double()
    ids = i.clamp_min(0).long()
    rows = row_of[ids]
    if bool((rows[fin] < 0).any()):
        raise ValueError("err_vs_exact: an output id is not in the window")
    x = X[rows.clamp_min(0)].double()                       # [b, k, d]
    q = Q.double()[:, None, :]
    cross = (x * q).sum(-1)
    weight = (x * q).abs().sum(-1)
    if mode == "l2sq":
        exact = (qsq.double()[:, None] - 2.0 * cross) + pen_of[ids]
        weight = 2.0 * weight
    else:
        exact = (1.0 - cross) + pen_of[ids]
    err = (d.double() - exact).abs()[fin]
    rel = err / weight[fin].clamp_min(torch.finfo(torch.float64).tiny)
    return float(err.max()), float(rel.max())


def _block_distances(Q, X, qsq, rows, pen, mode: str):
    x = X[rows.long()]                                      # [b, c, d]
    if mode == "ham":
        xor = torch.bitwise_xor(x, Q[:, None, :])
        return popcount32(xor).sum(dim=-1).to(torch.float32) + pen
    cross = _cross(x, Q)
    if mode == "l2sq":
        return (qsq[:, None] - 2.0 * cross) + pen
    return (1.0 - cross) + pen


def rerank_topk_plain(cand_rows, Q, qsq, cand_ids, pen, X, *, mode: str,
                      k: int, bc: int = 1024, bq: int = 256):
    """Plain version of the kernel: queries in blocks of ``bq``, candidates
    in blocks of ``bc`` gathered and scored in the kernel's order of
    summation, each folded into the running state through
    ``merge_topk_unique_rounds``."""
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


def rerank_dist_plain(cand_rows, Q, qsq, cand_ids, pen, X, *, mode: str,
                      bq: int = 256):
    """Plain version of the window distances-out entry: the [b, C]
    distances of the window, +inf at masked slots (+inf penalty or id
    -1), queries in blocks of ``bq``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    outs = []
    for q0 in range(0, cand_rows.shape[0], bq):
        q1 = min(q0 + bq, cand_rows.shape[0])
        d = _block_distances(Q[q0:q1], X, qsq[q0:q1], cand_rows[q0:q1],
                             pen[q0:q1], mode)
        outs.append(torch.where(cand_ids[q0:q1] < 0,
                                torch.full_like(d, float("inf")), d))
    return torch.cat(outs)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"rerank_topk kernel: {name} must be a contiguous {dtype} tensor "
            f"of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def _check_operands(cand_rows, Q, qsq, cand_ids, pen, X, mode: str):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
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
    return dev, b, C, d


def rerank_topk_kernel(cand_rows, Q, qsq, cand_ids, pen, X, *, mode: str,
                       k: int):
    """Launch the CUDA kernel on CUDA tensors (same contract as
    :func:`rerank_topk_plain`).  Raises on anything it does not take."""
    if not 1 <= k <= kernels.MAX_K:
        raise ValueError(f"rerank_topk kernel takes 1 <= k <= "
                         f"{kernels.MAX_K}, got k={k}")
    dev, b, C, d = _check_operands(cand_rows, Q, qsq, cand_ids, pen, X, mode)
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


def rerank_dist_kernel(cand_rows, Q, qsq, cand_ids, pen, X, *, mode: str):
    """Launch the window distances-out entry of ``csrc/rerank_topk.cu`` on
    CUDA tensors (same contract as :func:`rerank_dist_plain`)."""
    dev, b, C, d = _check_operands(cand_rows, Q, qsq, cand_ids, pen, X, mode)
    out = torch.empty((b, C), dtype=torch.float32, device=dev)
    fn = _dist_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(cand_rows.data_ptr(), Q.data_ptr(), qsq.data_ptr(),
                    cand_ids.data_ptr(), pen.data_ptr(), X.data_ptr(),
                    out.data_ptr(), b, C, d, MODES[mode], stream)
    kernels.check(status, "rerank_dist")
    rerank_dist_kernel.launches += 1
    return out


rerank_dist_kernel.launches = 0

_FN = None
_DIST_FN = None


def _dist_fn():
    global _DIST_FN
    if _DIST_FN is None:
        fn = kernels.load("rerank_topk").rerank_dist_launch
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _DIST_FN = fn
    return _DIST_FN


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
