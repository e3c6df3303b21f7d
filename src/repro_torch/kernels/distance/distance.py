"""Tiled distance matrix: the CUDA kernel's launcher, its plain PyTorch
version, and the distance epilogue shared with the streaming top-k
(``repro.kernels.distance.distance``).

``distance_matrix_kernel`` launches ``csrc/distance_matrix.cu`` on CUDA
tensors; ``distance_matrix_plain`` computes the same function with torch
ops.  Operands, as the kernel takes them:

    Q    [nq, d] float32
    X    [n, d]  float32
    qsq  [nq]    float32 squared query norms (read in l2sq only)
    xsq  [n]     float32 squared corpus norms (l2sq), or an additive
                 0 / +inf penalty per corpus row (every mode)

-> [nq, n] float32 distances.  The kernel's arithmetic is the streaming
top-k kernel's (one fmaf chain over d in index order, the epilogue rounded
operation by operation), so the distances-out route of
``ops.stream_topk`` gives that kernel's distances bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels

MODES = {"l2sq": 0, "ip": 1, "cos": 2}


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


def norm_operand(A, mode: str):
    """The qsq / xsq operand of A's rows: squared norms for "l2sq", zeros
    (no penalty) for "ip" / "cos"."""
    if mode == "l2sq":
        return torch.sum(A * A, dim=1)
    return torch.zeros(A.shape[0], dtype=torch.float32, device=A.device)


def distance_matrix_plain(Q, X, qsq, xsq, *, mode: str, bd=None):
    """Plain version of the kernel: the cross term accumulated over
    d-tiles of ``bd`` columns (all of d at once when None; the reference's
    Pallas grid accumulates over 128-wide tiles), then the epilogue."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    d = Q.shape[1]
    step = d if not bd else bd
    cross = Q[:, :step] @ X[:, :step].T
    for s in range(step, d, step):
        cross = cross + Q[:, s:s + step] @ X[:, s:s + step].T
    return distance_epilogue(cross, qsq.reshape(-1, 1), xsq.reshape(1, -1),
                             mode)


def _check(name, t, shape, device):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"distance_matrix kernel: {name} must be a contiguous float32 "
            f"tensor of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def distance_matrix_kernel(Q, X, qsq, xsq, *, mode: str):
    """Launch the CUDA kernel on CUDA tensors (same contract as
    :func:`distance_matrix_plain`).  Raises on anything it does not take."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not X.is_cuda:
        raise ValueError("distance_matrix kernel needs CUDA tensors")
    dev = X.device
    nq, d = Q.shape
    n = X.shape[0]
    if nq < 1 or n < 1 or d < 1:
        raise ValueError(f"empty operand: nq={nq}, n={n}, d={d}")
    _check("Q", Q, (nq, d), dev)
    _check("X", X, (n, d), dev)
    _check("qsq", qsq, (nq,), dev)
    _check("xsq", xsq, (n,), dev)
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    fn = _launch_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(Q.data_ptr(), X.data_ptr(), qsq.data_ptr(),
                    xsq.data_ptr(), out.data_ptr(), nq, n, d, n,
                    MODES[mode], stream)
    kernels.check(status, "distance_matrix")
    distance_matrix_kernel.launches += 1
    return out


distance_matrix_kernel.launches = 0

_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        fn = kernels.load("distance_matrix").distance_matrix_launch
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_longlong, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN
