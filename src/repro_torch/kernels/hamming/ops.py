"""Public wrapper for the Hamming top-k kernel
(``repro.kernels.hamming.ops``).

The tile clamps and the padding are the reference's: queries are padded
to a multiple of ``bq`` and the corpus to a multiple of ``bn`` with zero
words, and the kernel masks corpus rows at or past ``n_valid`` (the true
corpus length) so that a padded row never wins.  CUDA tensors go to the
hand-written kernel (``csrc/hamming_topk.cu``), CPU tensors to its plain
version.
"""

from __future__ import annotations

import torch

from repro_torch.bits import words_to_tensor
from repro_torch.kernels.hamming.hamming import (hamming_topk_kernel,
                                                 hamming_topk_plain)


def hamming_topk(Q, X, *, k: int, bq: int = 64, bn: int = 512):
    """(dists [nq, kk] f32, ids [nq, kk] int32) of the kk = min(k, n)
    nearest rows by popcount distance.  ``X`` (packed uint32 words, as an
    int32 tensor or a uint32 array) fixes the device."""
    X = words_to_tensor(X, X.device if torch.is_tensor(X) else "cpu")
    Q = words_to_tensor(Q, X.device)
    nq, w = Q.shape
    n = X.shape[0]
    bq = min(bq, max(8, nq))
    bn = min(bn, max(128, n))
    Qp = torch.nn.functional.pad(Q, (0, 0, 0, (-nq) % bq)).contiguous()
    Xp = torch.nn.functional.pad(X, (0, 0, 0, (-n) % bn)).contiguous()
    fn = hamming_topk_kernel if X.is_cuda else hamming_topk_plain
    vals, idx = fn(Qp, Xp, n, k=min(k, n))
    return vals[:nq], idx[:nq]
