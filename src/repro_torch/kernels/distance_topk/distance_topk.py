"""Streaming fused distance + top-k: the CUDA kernel's launcher and its
plain PyTorch version (``repro.kernels.distance_topk.distance_topk``).

``stream_topk_kernel`` launches ``csrc/stream_topk.cu`` on CUDA tensors;
``stream_topk_plain`` computes the same function with torch ops, tile by
tile, in the reference's arithmetic.  ``ops.stream_topk`` picks one by the
tensors' device: the plain version only for CPU tensors, the kernel (or an
error) for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.distance.distance import distance_epilogue

NEG_ONE = -1
MODES = {"l2sq": 0, "ip": 1, "cos": 2}
BQ = 64             # queries per block (csrc/stream_topk.cu)
BN = 64             # corpus rows per tile
MAX_SPLITS = 128


def merge_topk_rounds(cand_d: torch.Tensor, cand_i: torch.Tensor, k: int):
    """The k smallest (dist, id) pairs per row from [bq, m] candidates.

    The reference runs k rounds of (min, first argmin, mask); a stable sort
    by distance picks the same entries in the same order (equal distances
    in position order).  Ids are -1 where the distance is not finite, i.e.
    where fewer than k finite candidates exist.
    """
    vals, pos = torch.sort(cand_d, dim=1, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    ids = torch.gather(cand_i, 1, pos)
    alive = torch.isfinite(vals)
    return vals, torch.where(alive, ids, torch.full_like(ids, NEG_ONE))


def stream_topk_plain(Q, X, qsq, xsq, *, mode: str, k: int,
                      bn: int = 16384):
    """Plain version of the kernel: corpus tiles of ``bn`` rows, one fp32
    matmul per tile, the shared epilogue, and a fold of (running k ∪ tile)
    through ``merge_topk_rounds``.  The running state precedes the tile and
    ids ascend within it, so ties go to the smaller id as in the kernel.

    Q [nq, d] f32, X [n, d] f32, qsq [nq] f32, xsq [n] f32 (norms or
    0/+inf penalty) -> ([nq, k] f32, [nq, k] int32).
    """
    nq, n = Q.shape[0], X.shape[0]
    vals = torch.full((nq, k), float("inf"), dtype=torch.float32,
                      device=Q.device)
    ids = torch.full((nq, k), NEG_ONE, dtype=torch.int32, device=Q.device)
    qn = qsq.reshape(nq, 1)
    for s in range(0, n, bn):
        e = min(s + bn, n)
        cross = Q @ X[s:e].T
        d = distance_epilogue(cross, qn, xsq[s:e].reshape(1, -1), mode)
        tile_ids = torch.arange(s, e, dtype=torch.int32,
                                device=Q.device).expand(nq, -1)
        vals, ids = merge_topk_rounds(torch.cat([vals, d], dim=1),
                                      torch.cat([ids, tile_ids], dim=1), k)
    return vals, ids


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"stream_topk kernel: {name} must be a contiguous {dtype} tensor "
            f"of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def pick_splits(nq: int, n: int, device: torch.device) -> int:
    """How many corpus ranges each query tile is split into, so that the
    grid holds about eight blocks per SM (four resident, two waves)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-nq // BQ)
    want = -(-8 * sms // q_tiles)
    return max(1, min(want, MAX_SPLITS, -(-n // (4 * BN))))


def stream_topk_kernel(Q, X, qsq, xsq, *, mode: str, k: int):
    """Launch the CUDA kernel on CUDA tensors (same contract as
    :func:`stream_topk_plain`).  Raises on anything it does not take."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not 1 <= k <= kernels.MAX_K:
        raise ValueError(f"stream_topk kernel takes 1 <= k <= "
                         f"{kernels.MAX_K}, got k={k}")
    if not Q.is_cuda:
        raise ValueError("stream_topk kernel needs CUDA tensors")
    dev = Q.device
    nq, d = Q.shape
    n = X.shape[0]
    if nq < 1 or n < 1 or d < 1:
        raise ValueError(f"empty operand: nq={nq}, n={n}, d={d}")
    _check("Q", Q, torch.float32, (nq, d), dev)
    _check("X", X, torch.float32, (n, d), dev)
    _check("qsq", qsq, torch.float32, (nq,), dev)
    _check("xsq", xsq, torch.float32, (n,), dev)
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
        status = fn(Q.data_ptr(), X.data_ptr(), qsq.data_ptr(),
                    xsq.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
                    out_d.data_ptr(), out_i.data_ptr(), nq, n, d, k,
                    MODES[mode], splits, rows, stream)
    kernels.check(status, "stream_topk")
    stream_topk_kernel.launches += 1
    return out_d, out_i


stream_topk_kernel.launches = 0

_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        fn = kernels.load("stream_topk").stream_topk_launch
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN
