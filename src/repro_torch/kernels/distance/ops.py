"""Public wrapper for the tiled distance-matrix kernel
(``repro.kernels.distance.ops``).

The TPU wrapper pads Q and X to tile multiples for ``BlockSpec``; the CUDA
kernel masks its ragged edges itself, so nothing is padded or copied here.
The norm operands are the reference's: squared norms for "l2sq", zeros for
"ip" / "cos" (the Pallas kernel adds 0.0 there and ignores the norm rows).
CUDA tensors go to the kernel (``distance_matrix_kernel``), CPU tensors to
its plain version, which accumulates over the reference's d-tiles.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels.distance.distance import (MODES,
                                                   distance_matrix_kernel,
                                                   distance_matrix_plain,
                                                   norm_operand)


def pick_tiles(nq: int, n: int, d: int,
               vmem_budget: int = 8 * 1024 * 1024):
    """The reference's (bq, bn, bd) tile choice; the plain version
    accumulates the cross term over its ``bd``-wide d-tiles."""
    bq = min(128, max(8, nq))
    bd = 128 if d >= 128 else max(8, d)
    bn = 512
    while 4 * (bq * bd + bn * bd + 2 * bq * bn) > vmem_budget and bn > 128:
        bn //= 2
    return bq, bn, bd


def distance_matrix(Q, X, *, mode: str = "l2sq", device=None):
    """D [nq, n] float32 distances; mode in {"l2sq", "ip", "cos"}.

    A tensor ``X`` fixes the device; arrays go to ``device`` (``cuda``
    unless the caller asks for ``cpu``)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    dev = X.device if torch.is_tensor(X) else resolve_device(device)
    X = torch.as_tensor(X).to(device=dev, dtype=torch.float32).contiguous()
    Q = torch.as_tensor(Q).to(device=dev, dtype=torch.float32).contiguous()
    qsq, xsq = norm_operand(Q, mode), norm_operand(X, mode)
    if X.is_cuda:
        return distance_matrix_kernel(Q, X, qsq, xsq, mode=mode)
    bd = pick_tiles(Q.shape[0], X.shape[0], Q.shape[1])[2]
    return distance_matrix_plain(Q, X, qsq, xsq, mode=mode, bd=bd)
