"""The distance epilogue shared by the streaming top-k kernel and its plain
version (``repro.kernels.distance.distance.distance_epilogue``).

The tiled distance-matrix kernel itself (``distance_matrix_pallas``) is not
ported yet; see ROADMAP "TPU kernels to port".
"""

from __future__ import annotations

import torch


def distance_epilogue(cross, qsq, xsq, mode: str):
    """Turn an accumulated cross tile ``Q @ X^T`` into distances.

    ``qsq`` [bq, 1] / ``xsq`` [1, bn] are the squared norms for "l2sq".  For
    "ip"/"cos" the ``xsq`` row doubles as an additive per-corpus-row penalty
    (0 for valid rows, +inf for masked rows).  The expression trees are the
    reference's, including the clamp at 0 in "l2sq".
    """
    if mode == "l2sq":
        return torch.clamp_min(qsq - 2.0 * cross + xsq, 0.0)
    if mode == "ip":
        return -cross + xsq
    if mode == "cos":
        return 1.0 - cross + xsq
    raise ValueError(mode)
