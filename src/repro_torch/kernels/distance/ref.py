"""Plain torch oracle for the distance matrix (``repro.kernels.distance.ref``)."""

from __future__ import annotations

import torch


def distance_matrix_ref(Q, X, *, mode: str = "l2sq") -> torch.Tensor:
    Q = Q.to(torch.float32)
    X = X.to(torch.float32)
    cross = Q @ X.T
    if mode == "l2sq":
        qsq = torch.sum(Q * Q, dim=1, keepdim=True)
        xsq = torch.sum(X * X, dim=1)[None, :]
        return torch.clamp_min(qsq - 2.0 * cross + xsq, 0.0)
    if mode == "ip":
        return -cross
    if mode == "cos":
        return 1.0 - cross
    raise ValueError(mode)
