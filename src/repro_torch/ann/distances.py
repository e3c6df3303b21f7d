"""Distance functions shared by algorithms, ground truth and the results
layer (``repro.ann.distances``).  Conventions follow ann-benchmarks:

    euclidean : l2 norm  ||q - x||
    angular   : 1 - cos(q, x)            (in [0, 2])
    hamming   : popcount(q XOR x)        (packed 32-bit words)

``distance_matrix`` is the tensor building block; ``pairwise_rows`` is the
numpy-facing re-computation the framework runs after each run (paper §3.6:
"the experiment loop independently re-computes distance values after the
query has otherwise finished").  Packed words are int32 tensors holding the
uint32 bits (see :mod:`repro_torch.bits`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bits import popcount32, words_to_tensor

METRICS = ("euclidean", "angular", "hamming")


def sq_l2_matrix(Q: torch.Tensor, X: torch.Tensor,
                 x_sqnorm: torch.Tensor | None = None) -> torch.Tensor:
    """Squared L2 distances via the expansion ||q||^2 - 2 q.x + ||x||^2,
    fp32 throughout, clamped at 0."""
    Q = Q.to(torch.float32)
    X = X.to(torch.float32)
    qn = torch.sum(Q * Q, dim=1, keepdim=True)
    xn = torch.sum(X * X, dim=1)[None, :] if x_sqnorm is None \
        else x_sqnorm[None, :]
    cross = Q @ X.T
    return torch.clamp_min(qn - 2.0 * cross + xn, 0.0)


def _normalize(A: torch.Tensor) -> torch.Tensor:
    return A / torch.clamp_min(torch.linalg.norm(A, dim=1, keepdim=True),
                               1e-12)


def angular_matrix(Q: torch.Tensor, X: torch.Tensor,
                   normalized: bool = False) -> torch.Tensor:
    Q = Q.to(torch.float32)
    X = X.to(torch.float32)
    if not normalized:
        Q = _normalize(Q)
        X = _normalize(X)
    return 1.0 - Q @ X.T


def angular_matrix_exact(Q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """:func:`angular_matrix` (``normalized=False``) with each dot product
    accumulated in float64 and rounded once to float32: the products of
    float32 values are exact in float64, so a pair's distance depends on
    where it sits in the matrix, or on the matrix's shape, only where the
    float64 sum lies within its own rounding error of a float32 rounding
    boundary.  A mutable index's BruteForce main uses it
    (``bruteforce.exact_angular``), so that exact copies of a row, scanned
    in different matrices, tie exactly."""
    Q = _normalize(Q.to(torch.float32))
    X = _normalize(X.to(torch.float32))
    dot = (Q.to(torch.float64) @ X.to(torch.float64).T).to(torch.float32)
    return 1.0 - dot


def hamming_matrix(Q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Popcount distances between packed 32-bit codes; returns float32."""
    x = torch.bitwise_xor(Q[:, None, :], X[None, :, :])
    return popcount32(x).sum(dim=-1).to(torch.float32)


def masked_rows_to(X: torch.Tensor, q: torch.Tensor, ids: torch.Tensor,
                   metric: str) -> torch.Tensor:
    """Distances from ONE query ``q [d]`` to the gathered rows ``X[ids]``
    (``ids [m]``), or from each query of a batch ``q [b, d]`` to its own
    rows (``ids [b, m]``); entries with ``ids < 0`` come back +inf
    (gather-safe).  Squared L2 for euclidean, ``1 - x.q`` for angular: the
    beam-search comparator the graph algorithms share."""
    x = X[torch.clamp_min(ids, 0).long()]
    if metric == "angular":
        d = 1.0 - (x @ q if q.dim() == 1
                   else torch.bmm(x, q[:, :, None])[:, :, 0])
    else:
        diff = x - q[..., None, :]
        d = torch.sum(diff * diff, dim=-1)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def distance_matrix(Q, X, metric: str) -> torch.Tensor:
    if metric == "euclidean":
        return torch.sqrt(sq_l2_matrix(Q, X))
    if metric == "angular":
        return angular_matrix(Q, X)
    if metric == "hamming":
        return hamming_matrix(Q, X)
    raise ValueError(f"unknown metric {metric!r}")


def single(q, x, metric: str, device=None) -> float:
    """The distance between one query and one point.  A tensor ``q`` fixes
    the device; arrays go to ``device`` (``cuda`` unless the caller asks
    for ``cpu``).  Hamming codes are packed 32-bit words."""
    dev = q.device if torch.is_tensor(q) else resolve_device(device)
    if metric == "hamming":
        Q, X = words_to_tensor(q, dev), words_to_tensor(x, dev)
    else:
        Q = torch.as_tensor(q, dtype=torch.float32, device=dev)
        X = torch.as_tensor(x, dtype=torch.float32, device=dev)
    return float(distance_matrix(Q[None, :], X[None, :], metric)[0, 0])


def pairwise_rows(test: np.ndarray, train: np.ndarray,
                  neighbors: np.ndarray, metric: str,
                  device=None) -> np.ndarray:
    """distances[i, j] = dist(test[i], train[neighbors[i, j]]); inf where
    neighbors is -1 padding.  The rows are gathered on the host and the
    distances computed on ``device``, in blocks to bound memory."""
    dev = resolve_device(device)
    nq, k = neighbors.shape
    out = np.full((nq, k), np.inf, np.float32)
    block = max(1, 4_000_000 // max(k * train.shape[1], 1))
    for s in range(0, nq, block):
        e = min(s + block, nq)
        idx = np.clip(neighbors[s:e], 0, train.shape[0] - 1)
        d = _rows(test[s:e], train[idx], metric, dev).cpu().numpy()
        d = np.array(d, np.float32, copy=True)
        d[neighbors[s:e] < 0] = np.inf
        out[s:e] = d
    return out


def _rows(q, cand, metric: str, dev) -> torch.Tensor:
    """q [b, d], cand [b, k, d] (host arrays) -> [b, k] distances."""
    if metric == "hamming":
        x = torch.bitwise_xor(words_to_tensor(cand, dev),
                              words_to_tensor(q, dev)[:, None, :])
        return popcount32(x).sum(dim=-1).to(torch.float32)
    q = torch.as_tensor(np.asarray(q, np.float32), device=dev)
    cand = torch.as_tensor(np.asarray(cand, np.float32), device=dev)
    if metric == "euclidean":
        diff = cand - q[:, None, :]
        return torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1),
                                          0.0))
    if metric == "angular":
        qn = q / torch.clamp_min(torch.linalg.norm(q, dim=1, keepdim=True),
                                 1e-12)
        cn = cand / torch.clamp_min(
            torch.linalg.norm(cand, dim=2, keepdim=True), 1e-12)
        return 1.0 - torch.einsum("bd,bkd->bk", qn, cn)
    raise ValueError(metric)
