"""Public wrapper for the Hamming top-k kernel
(``repro.kernels.hamming.ops``).

The tile clamps and the padding are the reference's: queries are padded
to a multiple of ``bq`` and the corpus to a multiple of ``bn`` with zero
words, and the kernel masks corpus rows at or past ``n_valid`` (the true
corpus length) so that a padded row never wins.  CUDA tensors go to the
hand-written kernel (``csrc/hamming_topk.cu``), CPU tensors to its plain
version.  Above ``kernels.MAX_K`` (the kernel's lists live in shared
memory) both go through the distances-out route: the popcount distances
of a chunk of queries into a buffer (the kernel's second entry, or its
plain version), then a stable sort by (dist, row).  The distances are
exact integers, so the route gives what the plain version gives.
"""

from __future__ import annotations

import torch

from repro_torch import kernels, resolve_device
from repro_torch.bits import words_to_tensor
from repro_torch.kernels.hamming.hamming import (hamming_dist_kernel,
                                                 hamming_dist_plain,
                                                 hamming_topk_kernel,
                                                 hamming_topk_plain)


def hamming_topk(Q, X, *, k: int, bq: int = 64, bn: int = 512, device=None):
    """(dists [nq, kk] f32, ids [nq, kk] int32) of the kk = min(k, n)
    nearest rows by popcount distance.  ``X`` (packed uint32 words, as an
    int32 tensor or a uint32 array) fixes the device when it is a tensor;
    an array goes to ``device`` (``cuda`` unless the caller asks for
    ``cpu``)."""
    dev = X.device if torch.is_tensor(X) else resolve_device(device)
    X = words_to_tensor(X, dev)
    Q = words_to_tensor(Q, X.device)
    nq, w = Q.shape
    n = X.shape[0]
    bq = min(bq, max(8, nq))
    bn = min(bn, max(128, n))
    Qp = torch.nn.functional.pad(Q, (0, 0, 0, (-nq) % bq)).contiguous()
    Xp = torch.nn.functional.pad(X, (0, 0, 0, (-n) % bn)).contiguous()
    k = min(k, n)
    if k > kernels.MAX_K:
        vals, idx = distances_route(Qp[:nq], Xp, n, k=k)
    else:
        fn = hamming_topk_kernel if X.is_cuda else hamming_topk_plain
        vals, idx = fn(Qp, Xp, n, k=k)
    return vals[:nq], idx[:nq]


def distances_route(Q, X, n_valid: int, *, k: int):
    """The top-k kernel's contract for any k: popcount distances out per
    chunk of queries, then the k smallest (dist, row) by a stable sort."""
    dist = hamming_dist_kernel if X.is_cuda else hamming_dist_plain
    rows = torch.arange(X.shape[0], dtype=torch.int32, device=X.device)
    return kernels.by_query_chunks(Q.shape[0], lambda s, e: dist(
        Q[s:e].contiguous(), X, n_valid), rows, k)
