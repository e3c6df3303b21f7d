"""Hamming distance + top-k over packed codes: the CUDA kernel's launcher
and its plain PyTorch version (``repro.kernels.hamming.hamming``).

``hamming_topk_kernel`` launches ``csrc/hamming_topk.cu`` on CUDA tensors;
``hamming_topk_plain`` computes the same function with torch ops.
Operands, as the TPU kernel takes them:

    Q        [nq, w] int32   query words (the uint32 bits, ``bits.py``)
    X        [n, w]  int32   corpus words; rows at or past n_valid are
                             padding and never win
    n_valid  int             true corpus length

-> ([nq, k] float32, [nq, k] int32): per query the k smallest
(popcount(q XOR x), row) pairs by (dist, row), (+inf, -1) where fewer
than k rows exist.  Distances are integers held in float32, so the kernel
and the plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.bits import popcount32
from repro_torch.kernels.distance_topk.distance_topk import merge_topk_rounds

BQ = 64             # queries per block (csrc/hamming_topk.cu)
BN = 64             # corpus rows per tile
MAX_SPLITS = 128    # csrc/topk_list.cuh


def hamming_topk_plain(Q, X, n_valid: int, *, k: int, bq: int = 1024,
                       bn: int = 8192):
    """Plain version of the kernel: query blocks of ``bq`` against corpus
    tiles of ``bn`` rows, XOR + popcount, rows >= ``n_valid`` set to +inf,
    each tile folded into the running (dist, row) state through
    ``merge_topk_rounds`` (the running state precedes the tile and rows
    ascend within it, so ties go to the smaller row)."""
    nq, n = Q.shape[0], X.shape[0]
    outs_d, outs_i = [], []
    for q0 in range(0, nq, bq):
        q = Q[q0:q0 + bq]
        vals = torch.full((q.shape[0], k), float("inf"), device=X.device)
        ids = torch.full((q.shape[0], k), -1, dtype=torch.int32,
                         device=X.device)
        for s in range(0, n, bn):
            e = min(s + bn, n)
            d = popcount32(torch.bitwise_xor(q[:, None, :], X[None, s:e])) \
                .sum(dim=-1).to(torch.float32)
            rows = torch.arange(s, e, dtype=torch.int32, device=X.device)
            d = torch.where(rows[None, :] < n_valid, d,
                            torch.full_like(d, float("inf")))
            vals, ids = merge_topk_rounds(
                torch.cat([vals, d], dim=1),
                torch.cat([ids, rows.expand(q.shape[0], -1)], dim=1), k)
        outs_d.append(vals)
        outs_i.append(ids)
    return torch.cat(outs_d), torch.cat(outs_i)


def hamming_dist_plain(Q, X, n_valid: int):
    """Plain version of the distances-out entry: the [nq, n] popcount
    distances as float32, rows at or past ``n_valid`` at +inf."""
    d = torch.zeros((Q.shape[0], X.shape[0]), dtype=torch.int64,
                    device=X.device)
    for c in range(Q.shape[1]):                  # one word at a time
        d += popcount32(torch.bitwise_xor(Q[:, c:c + 1], X[None, :, c]))
    d = d.to(torch.float32)
    rows = torch.arange(X.shape[0], device=X.device)
    return torch.where(rows[None, :] < n_valid, d,
                       torch.full_like(d, float("inf")))


def pick_splits(nq: int, n: int, device: torch.device) -> int:
    """How many corpus ranges each query tile is split into, so that the
    grid holds about eight blocks per SM (four resident, two waves)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-nq // BQ)
    want = -(-8 * sms // q_tiles)
    return max(1, min(want, MAX_SPLITS, -(-n // (4 * BN))))


def _check(name, t, shape, device):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"hamming_topk kernel: {name} must be a contiguous int32 tensor "
            f"of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def hamming_topk_kernel(Q, X, n_valid: int, *, k: int):
    """Launch the CUDA kernel on CUDA tensors (same contract as
    :func:`hamming_topk_plain`).  Raises on anything it does not take."""
    if not 1 <= k <= kernels.MAX_K:
        raise ValueError(f"hamming_topk kernel takes 1 <= k <= "
                         f"{kernels.MAX_K}, got k={k}")
    if not X.is_cuda:
        raise ValueError("hamming_topk kernel needs CUDA tensors")
    dev = X.device
    nq, w = Q.shape
    n = X.shape[0]
    if nq < 1 or n < 1 or w < 1:
        raise ValueError(f"empty operand: nq={nq}, n={n}, w={w}")
    _check("Q", Q, (nq, w), dev)
    _check("X", X, (n, w), dev)
    n_valid = max(0, min(int(n_valid), n))
    splits = pick_splits(nq, n, dev)
    per_split = -(-n // splits)
    rows = -(-per_split // BN) * BN
    splits = -(-n // rows)
    part_d = torch.empty((splits, nq, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, nq, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    fn = _launch_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(Q.data_ptr(), X.data_ptr(), part_d.data_ptr(),
                    part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                    nq, n, w, n_valid, k, splits, rows, stream)
    kernels.check(status, "hamming_topk")
    hamming_topk_kernel.launches += 1
    return out_d, out_i


hamming_topk_kernel.launches = 0


def hamming_dist_kernel(Q, X, n_valid: int):
    """Launch the distances-out entry of ``csrc/hamming_topk.cu`` on CUDA
    tensors (same contract as :func:`hamming_dist_plain`)."""
    if not X.is_cuda:
        raise ValueError("hamming_dist kernel needs CUDA tensors")
    dev = X.device
    nq, w = Q.shape
    n = X.shape[0]
    if nq < 1 or n < 1 or w < 1:
        raise ValueError(f"empty operand: nq={nq}, n={n}, w={w}")
    _check("Q", Q, (nq, w), dev)
    _check("X", X, (n, w), dev)
    n_valid = max(0, min(int(n_valid), n))
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    fn = _dist_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(Q.data_ptr(), X.data_ptr(), out.data_ptr(), nq, n, w,
                    n_valid, n, stream)
    kernels.check(status, "hamming_dist")
    hamming_dist_kernel.launches += 1
    return out


hamming_dist_kernel.launches = 0

_FN = None
_DIST_FN = None


def _dist_fn():
    global _DIST_FN
    if _DIST_FN is None:
        fn = kernels.load("hamming_topk").hamming_dist_launch
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        _DIST_FN = fn
    return _DIST_FN


def _launch_fn():
    global _FN
    if _FN is None:
        fn = kernels.load("hamming_topk").hamming_topk_launch
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN
