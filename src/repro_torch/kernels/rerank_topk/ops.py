"""Public wrapper for the fused candidate rerank
(``repro.kernels.rerank_topk.ops``).

``rerank_topk`` reduces a [b, C] window of candidate rows to the k best
distinct ids without materializing the [b, C, d] gathered tensor.  Two
paths with identical select semantics:

  * **torch streaming fold** (default): the candidate axis in blocks folded
    through the canonical unique top-k (``ann.topk.chunked_topk(unique=
    True)``), one [b, block, d] gathered chunk at a time;
  * **kernel** (``use_kernel=True``, the ``rerank_kernel`` build flag): the
    hand-written Hopper kernel ``csrc/rerank_topk.cu`` on CUDA tensors, its
    plain PyTorch version on CPU tensors.  This wrapper pre-folds masking
    into the penalty and id operands, exactly as the TPU wrapper does.
    Above ``kernels.MAX_K`` (the kernel's lists live in shared memory) the
    kernel's window distances-out entry writes the [chunk, C] distances
    and a unique-by-id select follows (``distances_route``).

``rerank_lists`` is the kernel's list entry (IVF's fp32 search): the same
result as ``rerank_topk(use_kernel=True)`` on the window of the probed
lists, computed list by list on CUDA tensors without that window
(``lists.py``); on CPU tensors, and above ``kernels.MAX_K``, it builds the
window and takes ``rerank_topk``'s kernel path.

Both return what ``topk_unique`` over the materialized gather returns
(``ref.rerank_topk_ref``): masked (-1) candidates never win, duplicate ids
collapse to their best distance, rows with fewer than k distinct finite
candidates pad with (+inf, -1).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.bits import popcount32, words_to_tensor
from repro_torch.kernels.rerank_topk import lists
from repro_torch.kernels.rerank_topk.rerank_topk import (
    rerank_dist_kernel, rerank_dist_plain, rerank_topk_kernel,
    rerank_topk_plain)

_FOLD_BUDGET = 32 << 20     # torch fold: gathered-chunk working set


def pick_rerank_block(b: int, C: int, d: int, k: int, *,
                      itemsize: int = 4, budget: int = _FOLD_BUDGET) -> int:
    """Candidate-block size for the streaming fold: the largest power of two
    (128..4096) whose [b, block, d] gathered chunk plus merge state, at
    ``itemsize`` bytes an entry, fits ``budget``; small windows collapse to
    one block."""
    block = 4096

    def working_set(blk: int) -> int:
        return itemsize * max(1, b) * (blk * (d + 2) + 3 * k)

    while block > 128 and block >= 2 * max(1, C):
        block //= 2
    while block > 128 and working_set(block) > budget:
        block //= 2
    return block


def _as_queries(Q, metric: str, device):
    if metric == "hamming":
        return words_to_tensor(Q, device)
    return torch.as_tensor(Q).to(device=device, dtype=torch.float32)


def _chunk_distances(Q, X, qsq, xsq, cand, bad, row_ids, metric: str):
    """Exact (dist, id) for one candidate chunk, in the reference's
    expression trees (``repro.kernels.rerank_topk.ops._chunk_distances``)."""
    inf = torch.tensor(float("inf"), device=X.device)
    safe = torch.clamp_min(cand, 0).long()
    x = X[safe]                                           # [b, c, d]
    if metric == "hamming":
        pen = torch.where(bad, inf, 0.0)
        d = popcount32(torch.bitwise_xor(x, Q[:, None, :])).sum(dim=-1) \
            .to(torch.float32) + pen
    elif metric == "euclidean":
        cross = torch.einsum("bcd,bd->bc", x, Q)
        pen = torch.where(bad, inf, xsq[safe])
        d = (qsq - 2.0 * cross) + pen
    else:                                                 # angular
        pen = torch.where(bad, inf, 0.0)
        d = (1.0 - torch.einsum("bcd,bd->bc", x, Q)) + pen
    ids = cand if row_ids is None else row_ids[safe].to(torch.int32)
    return d, torch.where(bad, torch.full_like(ids, -1), ids)


def rerank_topk(Q, X, cand, *, k: int, metric: str, xsq=None, row_ids=None,
                valid=None, block: Optional[int] = None,
                use_kernel: bool = False):
    """(dists [b, kk], ids [b, kk]) of the k best DISTINCT candidates.

    ``cand [b, C]``  int32 row indices into ``X``; -1 marks a masked slot.
    ``valid``        optional extra [b, C] bool mask (the IVF probe / scan
                     windows flow in here).
    ``row_ids``      optional [n] row -> output-id map (IVF's cluster-major
                     corpus); identity when omitted.
    ``xsq``          cached [n] squared norms (required for euclidean).
    ``block``        candidate-block override for the fold.
    ``use_kernel``   route through the hand-written Hopper kernel (its plain
                     version for CPU tensors).

    ``X`` fixes the device.  kk = min(k, C).
    """
    if metric == "euclidean" and xsq is None:
        raise ValueError("euclidean rerank needs the cached xsq table "
                         "(build-time sum(X**2, dim=1))")
    dev = X.device
    cand = torch.as_tensor(cand, device=dev).to(torch.int32)
    b, C = cand.shape
    kk = min(int(k), C)
    if C == 0:                         # empty window: nothing to rerank
        return (torch.full((b, 0), float("inf"), device=dev),
                torch.full((b, 0), -1, dtype=torch.int32, device=dev))
    Q = _as_queries(Q, metric, dev)
    qsq = torch.sum(Q * Q, dim=1, keepdim=True) \
        if metric == "euclidean" else None
    bad = cand < 0
    if valid is not None:
        bad = bad | ~torch.as_tensor(valid, device=dev).to(torch.bool)

    if use_kernel and b > 0:
        ops = kernel_operands(Q, X, qsq, xsq, cand, bad, row_ids, metric, kk)
        if kk > kernels.MAX_K:
            return distances_route(**ops)
        fn = rerank_topk_kernel if X.is_cuda else rerank_topk_plain
        return fn(**ops)

    from repro_torch.ann.topk import chunked_topk   # deferred: import cycle

    blk = block if block else pick_rerank_block(b, C, Q.shape[1], kk)

    def chunk(s, size):
        return _chunk_distances(Q, X, qsq, xsq, cand[:, s:s + size],
                                bad[:, s:s + size], row_ids, metric)

    return chunked_topk(C, kk, blk, chunk, unique=True)


def rerank_lists(Q, X, probes, *, k: int, metric: str, starts, sizes,
                 M: int, row_ids, n_probes=None, scan=None, xsq=None,
                 row_live=None):
    """(dists [b, kk], ids [b, kk]), kk = min(k, P * M): the k best
    DISTINCT ids of each query's window of its P probed lists, M rows each
    (``lists.list_window``), in the kernel's arithmetic.

    ``probes [b, P]``    the probed lists (``ann/ivf.py::coarse_probes``).
    ``starts, sizes``    [n_lists] each list's first row in ``X`` and length.
    ``row_ids``          [n] output id of each row of ``X``.
    ``n_probes``         None (every slot), an int or a 0-d device tensor:
                         probe slots past it are dead.
    ``scan``             None, an int or a 0-d device tensor: a list's rows
                         past max(scan, 1) are skipped.
    ``row_live``         optional [n] bool: rows that may be returned.

    Metrics euclidean and angular.  ``X`` fixes the device."""
    if metric not in ("euclidean", "angular"):
        raise ValueError(f"rerank_lists takes euclidean or angular, not "
                         f"{metric!r}")
    if metric == "euclidean" and xsq is None:
        raise ValueError("euclidean rerank needs the cached xsq table "
                         "(build-time sum(X**2, dim=1))")
    dev = X.device
    Q = _as_queries(Q, metric, dev)
    probes = torch.as_tensor(probes, device=dev)
    b, P = probes.shape
    kk = min(int(k), P * int(M))
    if b == 0 or kk == 0:
        return (torch.full((b, kk), float("inf"), device=dev),
                torch.full((b, kk), -1, dtype=torch.int32, device=dev))
    if kk > kernels.MAX_K or not X.is_cuda:
        cand, valid = lists.list_window(probes, starts, sizes, M,
                                        X.shape[0], n_probes=n_probes,
                                        scan=scan, row_live=row_live)
        return rerank_topk(Q, X, cand, k=k, metric=metric, xsq=xsq,
                           row_ids=row_ids, valid=valid, use_kernel=True)
    mode = "l2sq" if metric == "euclidean" else "cos"
    qsq = torch.sum(Q * Q, dim=1) if mode == "l2sq" \
        else torch.zeros(b, dtype=torch.float32, device=dev)
    live = None if row_live is None else \
        torch.as_tensor(row_live, device=dev).to(torch.uint8).contiguous()
    return lists.rerank_lists_kernel(
        Q.contiguous(), qsq, X.contiguous(),
        None if xsq is None else xsq.to(torch.float32).contiguous(),
        probes.contiguous(), starts.to(torch.int32).contiguous(),
        sizes.to(torch.int32).contiguous(),
        torch.as_tensor(row_ids, device=dev).to(torch.int32).contiguous(),
        M=int(M), mode=mode, k=int(k), n_probes=n_probes, scan=scan,
        row_live=live)


def distances_route(cand_rows, Q, qsq, cand_ids, pen, X, *, mode: str,
                    k: int):
    """The kernel's contract for any k: the window's distances out per
    chunk of queries (masked slots at +inf), then the unique-by-id select
    ``merge_topk_unique_rounds`` (the canonical ``topk_unique``)."""
    dist = rerank_dist_kernel if X.is_cuda else rerank_dist_plain
    return kernels.by_query_chunks(cand_rows.shape[0], lambda s, e: dist(
        cand_rows[s:e], Q[s:e], qsq[s:e], cand_ids[s:e], pen[s:e], X,
        mode=mode), cand_ids, k, unique=True)


def kernel_operands(Q, X, qsq, xsq, cand, bad, row_ids, metric: str,
                    kk: int) -> dict:
    """The kernel's operands, with masking pre-folded into the penalty and
    id operands (+inf / -1, the same treatment as the TPU wrapper).  The
    CUDA kernel takes any b and C, so nothing is padded.  ``qsq`` is the
    [b, 1] query norm column (None unless euclidean), ``bad`` the [b, C]
    mask of slots that must not win."""
    b = cand.shape[0]
    safe = torch.clamp_min(cand, 0)
    ids = cand if row_ids is None else row_ids[safe.long()].to(torch.int32)
    ids = torch.where(bad, torch.full_like(ids, -1), ids)
    inf = torch.tensor(float("inf"), device=X.device)
    if metric == "euclidean":
        pen = torch.where(bad, inf, xsq[safe.long()].to(torch.float32))
    else:
        pen = torch.where(bad, inf, torch.zeros((), device=X.device))
    qsq = torch.zeros(b, dtype=torch.float32, device=X.device) \
        if qsq is None else qsq.reshape(b)
    mode = {"euclidean": "l2sq", "angular": "cos", "hamming": "ham"}[metric]
    return dict(cand_rows=safe.contiguous(), Q=Q.contiguous(),
                qsq=qsq.contiguous(), cand_ids=ids.contiguous(),
                pen=pen.contiguous(), X=X.contiguous(), mode=mode, k=kk)
