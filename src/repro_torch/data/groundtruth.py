"""Exact ground truth (paper §3.2: dataset files ship the true k=100
neighbors + distances), as ``repro.data.groundtruth``.

Blocked brute force: the corpus goes to the device once, then query blocks
x corpus blocks with a running top-k merge, so the full distance matrix
never exists.  Each block is a plain ``torch.matmul`` distance matrix and a
stable top-k (ties to the lower id), merged with the running state ahead of
the block, as the reference's stable numpy merge does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ann import distances as D
from repro_torch.ann.topk import topk_smallest, topk_with_ids
from repro_torch.bits import words_to_tensor


def _to_device(a: np.ndarray, metric: str, dev) -> torch.Tensor:
    if metric == "hamming":
        return words_to_tensor(a, dev)
    return torch.as_tensor(np.asarray(a)).to(device=dev)


def exact_knn(
    train: np.ndarray,
    test: np.ndarray,
    k: int,
    metric: str,
    query_block: int = 512,
    corpus_block: int = 65536,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (neighbors [nq,k] int64, distances [nq,k] float32) exactly."""
    dev = resolve_device(device)
    n = train.shape[0]
    k = min(k, n)
    nq = test.shape[0]
    X = _to_device(train, metric, dev)
    all_idx = np.empty((nq, k), np.int64)
    all_dst = np.empty((nq, k), np.float32)
    for qs in range(0, nq, query_block):
        qe = min(qs + query_block, nq)
        q = _to_device(test[qs:qe], metric, dev)
        best_d = torch.full((qe - qs, k), float("inf"), device=dev)
        best_i = torch.full((qe - qs, k), -1, dtype=torch.int64, device=dev)
        for s in range(0, n, corpus_block):
            e = min(s + corpus_block, n)
            d = D.distance_matrix(q, X[s:e], metric)           # [bq, bn]
            d, i = topk_smallest(d, min(k, e - s))
            best_d, best_i = topk_with_ids(
                torch.cat([best_d, d], dim=1),
                torch.cat([best_i, i + s], dim=1), k)
        all_idx[qs:qe] = best_i.cpu().numpy()
        all_dst[qs:qe] = best_d.cpu().numpy()
    return all_idx, all_dst
