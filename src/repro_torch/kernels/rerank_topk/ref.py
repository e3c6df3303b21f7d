"""Plain torch oracle for the fused candidate rerank
(``repro.kernels.rerank_topk.ref``): materialize the whole [b, C, d]
gathered tensor, compute distances, one canonical ``topk_unique``."""

from __future__ import annotations

import torch

from repro_torch.bits import popcount32, words_to_tensor


def rerank_topk_ref(Q, X, cand, *, k: int, metric: str, xsq=None,
                    row_ids=None, valid=None):
    """(dists [b, kk], ids [b, kk]) over a [b, C] candidate window.

    ``cand`` holds row indices into ``X`` (-1 = masked); ``valid`` is an
    optional extra mask; ``row_ids`` optionally maps rows to output ids;
    ``xsq`` is the cached per-row squared-norm table (euclidean).
    kk = min(k, C).
    """
    from repro_torch.ann.topk import topk_unique   # deferred: import cycle

    dev = X.device
    cand = torch.as_tensor(cand, device=dev).to(torch.int32)
    bad = cand < 0
    if valid is not None:
        bad = bad | ~torch.as_tensor(valid, device=dev).to(torch.bool)
    safe = torch.clamp_min(cand, 0).long()
    x = X[safe]                                          # [b, C, d]
    inf = torch.tensor(float("inf"), device=dev)
    if metric == "hamming":
        Q = words_to_tensor(Q, dev)
        pen = torch.where(bad, inf, 0.0)
        d = popcount32(torch.bitwise_xor(x, Q[:, None, :])).sum(dim=-1) \
            .to(torch.float32) + pen
    elif metric == "euclidean":
        Q = torch.as_tensor(Q).to(device=dev, dtype=torch.float32)
        if xsq is None:
            xsq = torch.sum(X.to(torch.float32) ** 2, dim=1)
        qsq = torch.sum(Q * Q, dim=1, keepdim=True)
        cross = torch.einsum("bcd,bd->bc", x, Q)
        pen = torch.where(bad, inf, xsq[safe].to(torch.float32))
        d = (qsq - 2.0 * cross) + pen
    else:                                                # angular
        Q = torch.as_tensor(Q).to(device=dev, dtype=torch.float32)
        pen = torch.where(bad, inf, 0.0)
        d = (1.0 - torch.einsum("bcd,bd->bc", x, Q)) + pen
    ids = cand if row_ids is None else row_ids[safe].to(torch.int32)
    ids = torch.where(bad, torch.full_like(ids, -1), ids)
    return topk_unique(d, ids, min(k, cand.shape[1]))
