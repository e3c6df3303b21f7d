"""Public wrappers for the streaming fused distance + top-k kernel
(``repro.kernels.distance_topk.ops``).

``stream_topk``          one launch: norms / penalty row built here, the
                         corpus masked in-kernel, exact (dists, ids) out.
``stream_topk_batched``  query-block streaming driver: each block of
                         queries is one launch, so peak memory is
                         O(X + query_block * (d + k)) regardless of nq.

The TPU wrapper pads Q and X to tile multiples for ``BlockSpec``; the CUDA
kernel masks its ragged edges itself, so nothing is padded or copied here.
CUDA tensors go to the kernel (``stream_topk_kernel``), CPU tensors to its
plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.distance_topk.distance_topk import (
    stream_topk_kernel, stream_topk_plain)

_METRIC_TO_MODE = {"euclidean": "l2sq", "angular": "cos", "ip": "ip",
                   "l2sq": "l2sq", "cos": "cos"}


def _run(Q, X, qsq, xsq, mode: str, k: int):
    fn = stream_topk_kernel if X.is_cuda else stream_topk_plain
    return fn(Q, X, qsq, xsq, mode=mode, k=k)


def _corpus_row(X, mode: str):
    """The xsq operand: squared norms for l2sq, a zero penalty otherwise."""
    if mode == "l2sq":
        return torch.sum(X * X, dim=1)
    return torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)


def _query_col(Q, mode: str):
    if mode == "l2sq":
        return torch.sum(Q * Q, dim=1)
    return torch.zeros(Q.shape[0], dtype=torch.float32, device=Q.device)


def stream_topk(Q, X, *, k: int, metric: str = "euclidean",
                row_ids=None, valid=None):
    """(dists [nq,k], ids [nq,k]) of the k nearest corpus rows per query.

    ``X`` is a float32 tensor and fixes the device; ``Q`` may be a tensor
    or an array.  ``metric="angular"`` expects pre-normalised inputs.
    ``valid`` (optional [n] bool) masks corpus rows through the penalty
    operand; ``row_ids`` (optional [n] int32) remaps the returned rows to
    global ids (-1 for empty slots).
    """
    mode = _METRIC_TO_MODE[metric]
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    X = X.to(torch.float32).contiguous()
    Q = torch.as_tensor(Q).to(device=X.device, dtype=torch.float32)
    Q = Q.contiguous()
    n = X.shape[0]
    k = min(k, n)
    xsq = _corpus_row(X, mode)
    if valid is not None:
        keep = torch.as_tensor(valid, device=X.device).to(torch.bool)
        xsq = torch.where(keep, xsq, torch.full_like(xsq, float("inf")))
    vals, idx = _run(Q, X, _query_col(Q, mode), xsq.contiguous(), mode, k)
    if row_ids is not None:
        alive = torch.isfinite(vals)
        rid = torch.as_tensor(row_ids, device=X.device).to(torch.int32)
        gl = rid[torch.clamp(idx, 0, n - 1).long()]
        idx = torch.where(alive, gl, torch.full_like(gl, -1))
    return vals, idx


def stream_topk_batched(Q, X, *, k: int, metric: str = "euclidean",
                        query_block: int = 4096, materialize: bool = True):
    """Query-streaming mode: Q in blocks of ``query_block`` rows so any
    number of queries runs in constant device memory.  The corpus operand
    is built once, outside the loop.  The CUDA kernel takes a ragged last
    block as it is, so no block is padded.

    ``materialize=False`` returns device tensors without a host copy, so
    callers can keep the transfer off the benchmark clock (paper §3.5)."""
    mode = _METRIC_TO_MODE[metric]
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    X = X.to(torch.float32).contiguous()
    Q = torch.as_tensor(Q)
    nq = Q.shape[0]
    n = X.shape[0]
    k = min(k, n)
    query_block = max(1, min(query_block, nq))
    xsq = _corpus_row(X, mode)
    vals_out, ids_out = [], []
    for s in range(0, nq, query_block):
        blk = Q[s:s + query_block].to(device=X.device, dtype=torch.float32)
        blk = blk.contiguous()
        v, i = _run(blk, X, _query_col(blk, mode), xsq, mode, k)
        vals_out.append(v)
        ids_out.append(i)
    vals, ids = torch.cat(vals_out), torch.cat(ids_out)
    if materialize:
        return vals.cpu().numpy(), ids.cpu().numpy()
    return vals, ids
