"""Oracles for the streaming fused distance + top-k kernel
(``repro.kernels.distance_topk.ref``).

  * ``stream_topk_ref``        exact: the full distance matrix + a stable
                               top-k (ties to the lower index).
  * ``stream_topk_ref_scan``   the streaming algorithm in plain torch: corpus
                               tiles folded into a running (dist, id) state
                               through ``merge_topk``.
"""

from __future__ import annotations

import torch

from repro_torch.ann.topk import merge_topk, topk_smallest
from repro_torch.kernels.distance.ref import distance_matrix_ref


def stream_topk_ref(Q, X, *, k: int, mode: str = "l2sq"):
    d = distance_matrix_ref(Q, X, mode=mode)
    vals, idx = topk_smallest(d, k)
    return vals, idx.to(torch.int32)


def stream_topk_ref_scan(Q, X, *, k: int, mode: str = "l2sq",
                         bn: int = 1024):
    """Streaming scan over corpus tiles + merge_topk; never holds more than
    one [nq, bn] distance tile."""
    Q = Q.to(torch.float32)
    X = X.to(torch.float32)
    nq, n = Q.shape[0], X.shape[0]
    k = min(k, n)
    bn = min(bn, n)
    vals = torch.full((nq, k), float("inf"), device=Q.device)
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=Q.device)
    for s in range(0, n, bn):
        d = distance_matrix_ref(Q, X[s:s + bn], mode=mode)
        tile_ids = torch.arange(s, s + d.shape[1], dtype=torch.int32,
                                device=Q.device).expand(nq, -1)
        tile_ids = torch.where(torch.isfinite(d), tile_ids,
                               torch.full_like(tile_ids, -1))
        vals, ids = merge_topk(vals, ids, d, tile_ids, k)
    return vals, ids
