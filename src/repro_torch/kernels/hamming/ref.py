"""Plain torch oracle for the Hamming top-k kernel
(``repro.kernels.hamming.ref``): the full [nq, n] popcount matrix and one
stable top-k (ties to the lower row)."""

from __future__ import annotations

import torch

from repro_torch.ann.distances import hamming_matrix
from repro_torch.ann.topk import topk_smallest
from repro_torch.bits import words_to_tensor


def hamming_topk_ref(Q, X, *, k: int):
    X = words_to_tensor(X, X.device if torch.is_tensor(X) else "cpu")
    Q = words_to_tensor(Q, X.device)
    vals, idx = topk_smallest(hamming_matrix(Q, X), k)
    return vals, idx.to(torch.int32)
