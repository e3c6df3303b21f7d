"""Embedding-bag gather-reduce: the CUDA kernel's launcher and its plain
PyTorch version (``repro.kernels.embedbag.embedbag``).

``embedding_bag_kernel`` launches ``csrc/embedding_bag.cu`` on CUDA
tensors; ``embedding_bag_plain`` computes the same function with torch
ops.  Operands (``ops.embedding_bag`` builds them):

    indices  [N] int32    table row of each lookup (sorted by bag)
    weights  [N] float32  per-sample weight of each lookup
    table    [V, D]       float32 or bfloat16
    runs     (start [R], end [R], bag [R]) int32: the runs of equal bag ids
             that write (the last run of each bag)
    n_bags   int

-> [n_bags, D] in the table's type: for each run,
``out[bag] = row_0 * w_0; out[bag] += row_i * w_i`` in lookup order (each
multiply and add rounded on its own, the running value rounded to the
table's type after every step, as the Pallas kernel stores its output
block); rows of bags without a run are zero.  Kernel and plain version add
in the same order, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def embedding_bag_plain(indices, weights, table, runs, *, n_bags: int):
    """Plain version of the kernel: step j adds the j-th lookup of every
    run still that long, so each run sums in lookup order.  No
    ``index_add_``: its atomics on CUDA add in no fixed order."""
    start, end, bag = runs
    out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if start.numel() == 0:
        return out
    lens = (end - start).long()
    acc = None
    for j in range(int(lens.max())):
        live = torch.nonzero(lens > j).squeeze(1)
        pos = (start.long()[live] + j)
        row = table[indices[pos].long()].to(torch.float32) \
            * weights[pos][:, None]
        if acc is None:
            acc = row.to(table.dtype)
        else:
            acc[live] = (acc[live].to(torch.float32) + row).to(table.dtype)
    out[bag.long()] = acc
    return out


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"embedding_bag kernel: {name} must be a contiguous {dtype} "
            f"tensor of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def embedding_bag_kernel(indices, weights, table, runs, *, n_bags: int):
    """Launch the CUDA kernel on CUDA tensors (same contract as
    :func:`embedding_bag_plain`).  Raises on anything it does not take."""
    if not table.is_cuda:
        raise ValueError("embedding_bag kernel needs CUDA tensors")
    if table.dtype not in DTYPES:
        raise ValueError(f"embedding_bag kernel takes float32 or bfloat16 "
                         f"tables, got {table.dtype}")
    dev = table.device
    V, D = table.shape
    N = indices.shape[0]
    start, end, bag = runs
    R = start.shape[0]
    _check("indices", indices, torch.int32, (N,), dev)
    _check("weights", weights, torch.float32, (N,), dev)
    _check("table", table, table.dtype, (V, D), dev)
    for name, t in (("run starts", start), ("run ends", end),
                    ("run bags", bag)):
        _check(name, t, torch.int32, (R,), dev)
    out = torch.zeros((n_bags, D), dtype=table.dtype, device=dev)
    if R == 0:
        return out
    fn = _launch_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(indices.data_ptr(), weights.data_ptr(), table.data_ptr(),
                    start.data_ptr(), end.data_ptr(), bag.data_ptr(),
                    out.data_ptr(), R, D, DTYPES[table.dtype], stream)
    kernels.check(status, "embedding_bag")
    embedding_bag_kernel.launches += 1
    return out


embedding_bag_kernel.launches = 0

_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        fn = kernels.load("embedding_bag").embedding_bag_launch
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN
