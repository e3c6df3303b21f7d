"""ADC code scan: the CUDA kernel's launcher and its plain PyTorch version
(``repro.kernels.adc_scan.adc_scan``).

``adc_scan_kernel`` launches ``csrc/adc_scan.cu`` on CUDA tensors;
``adc_scan_plain`` computes the same function with torch ops.  Operands:

    codes [n, m]    uint8    packed code table
    luts  [b, m, K] float32  per-query lookup tables (``quant.build_luts``)

-> ([b, C] float32, [b, C] int32): per query the C smallest
(sum_j luts[q, j, codes[i, j]], row) pairs by (dist, row), the sum taken
over j in index order, (+inf, -1) where fewer than C rows exist.  Both
versions add in the same order, so they agree bit for bit.

The TPU kernel takes any C; this one takes C <= ``MAX_C`` (the running
lists live in shared memory) and raises above it.  For larger C,
``ops.adc_scan`` uses the sums-out entry of the same source
(``adc_sums_kernel``: the [b, n] sums, in the same order, into a buffer)
and selects by (dist, row).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.distance_topk.distance_topk import merge_topk_rounds

MAX_C = 1024         # largest C the kernel takes (csrc/adc_scan.cu)
TILE = 256           # rows per tile (threads per block)
MAX_G = 8            # queries per block
SMEM_MAX = 232448    # shared memory a block may use on sm_90
SMEM_TARGET = 113 * 1024   # two blocks per SM where the tables allow
MAX_SPLITS = 128


def sum_in_order(parts: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum ``dim`` in index order, one add at a time: the order the kernel
    (and the reference's ground rule) uses."""
    acc = torch.zeros_like(parts.select(dim, 0))
    for j in range(parts.shape[dim]):
        acc = acc + parts.select(dim, j)
    return acc


def lookup(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """[b, r] ADC distances of code rows [r, m] under tables [b, m, K]."""
    b, m, K = luts.shape
    offs = torch.arange(m, device=luts.device) * K
    idx = (codes.long().T + offs[:, None]).reshape(-1)          # [m*r]
    parts = luts.reshape(b, m * K)[:, idx].reshape(b, m, -1)   # [b, m, r]
    return sum_in_order(parts, dim=1)


def adc_scan_plain(codes, luts, *, k: int, bq: int = 1024,
                   budget: int = 1 << 30):
    """Plain version of the kernel: query blocks of ``bq`` against code
    tiles sized so the gathered [bq, tile, m] entries stay within
    ``budget`` bytes, each tile folded into the running (dist, row) state
    through ``merge_topk_rounds`` (state first, rows ascending within a
    tile: ties go to the smaller row)."""
    n, m = codes.shape
    b = luts.shape[0]
    outs_d, outs_i = [], []
    for q0 in range(0, b, bq):
        lq = luts[q0:q0 + bq]
        nb = lq.shape[0]
        bn = max(256, budget // (4 * nb * m))
        vals = torch.full((nb, k), float("inf"), device=luts.device)
        ids = torch.full((nb, k), -1, dtype=torch.int32, device=luts.device)
        for s in range(0, n, bn):
            e = min(s + bn, n)
            d = lookup(codes[s:e], lq)
            rows = torch.arange(s, e, dtype=torch.int32, device=luts.device)
            vals, ids = merge_topk_rounds(
                torch.cat([vals, d], dim=1),
                torch.cat([ids, rows.expand(nb, -1)], dim=1), k)
        outs_d.append(vals)
        outs_i.append(ids)
    return torch.cat(outs_d), torch.cat(outs_i)


def adc_sums_plain(codes, luts, *, budget: int = 1 << 30):
    """Plain version of the sums-out entry: the [b, n] ADC sums, each over
    the subspaces in index order, in code tiles whose gathered [b, tile, m]
    entries stay within ``budget`` bytes."""
    n, m = codes.shape
    b = luts.shape[0]
    bn = max(256, budget // (4 * b * m))
    return torch.cat([lookup(codes[s:s + bn], luts) for s in range(0, n, bn)],
                     dim=1)


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def plan(b: int, n: int, m: int, K: int, C: int, sms: int) -> dict:
    """Block shape for the kernel: queries per block G, whether the tables
    sit in shared memory, the list and buffer sizes, and the corpus split.

    Each query needs its table (m*K*4 bytes) and a list of P = pow2(C) plus
    a buffer of max(P, 2*TILE) (dist, row) pairs.  G is as large as two
    blocks per SM allow (at most 8); a table too large even for one query
    per block stays in device memory and is read through the caches."""
    P = _pow2(C)
    BUF = max(P, 2 * TILE)
    state = 8 * (P + BUF) + 4
    per = 4 * m * K + state
    if per <= SMEM_TARGET:
        G, lut_smem = SMEM_TARGET // per, True
    elif per <= SMEM_MAX:
        G, lut_smem = 1, True
    else:
        G, lut_smem = max(1, SMEM_TARGET // state), False
    G = max(1, min(G, MAX_G, b))
    smem = G * (per if lut_smem else state)
    per_sm = 2 if smem <= SMEM_TARGET else 1
    groups = -(-b // G)
    splits = max(1, min(-(-2 * sms * per_sm // groups), MAX_SPLITS,
                        -(-n // (4 * TILE))))
    per_split = -(-n // splits)
    rows = -(-per_split // TILE) * TILE
    splits = -(-n // rows)
    return dict(G=G, lut_smem=lut_smem, P=P, BUF=BUF, splits=splits,
                rows=rows, smem=smem)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"adc_scan kernel: {name} must be a contiguous {dtype} tensor "
            f"of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def adc_scan_kernel(codes, luts, *, k: int):
    """Launch the CUDA kernel on CUDA tensors (same contract as
    :func:`adc_scan_plain`).  Raises on anything it does not take,
    including C = ``k`` above :data:`MAX_C`."""
    if not 1 <= k <= MAX_C:
        raise ValueError(
            f"adc_scan kernel keeps at most C={MAX_C} candidates per query "
            f"(its lists live in shared memory), got C={k}; lower n_cand "
            f"or max_cand, or build without adc_kernel")
    if not codes.is_cuda:
        raise ValueError("adc_scan kernel needs CUDA tensors")
    dev = codes.device
    n, m = codes.shape
    b, _, K = luts.shape
    if b < 1 or n < 1 or m < 1 or K < 1:
        raise ValueError(f"empty operand: b={b}, n={n}, m={m}, K={K}")
    _check("codes", codes, torch.uint8, (n, m), dev)
    _check("luts", luts, torch.float32, (b, m, K), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = plan(b, n, m, K, k, sms)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if p["splits"] > 1:
        part_d = torch.empty((p["splits"], b, k), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((p["splits"], b, k), dtype=torch.int32,
                             device=dev)
    else:
        part_d, part_i = out_d, out_i
    fn = _launch_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(codes.data_ptr(), luts.data_ptr(), part_d.data_ptr(),
                    part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                    b, n, m, K, k, p["P"], p["BUF"], p["G"],
                    int(p["lut_smem"]), p["splits"], p["rows"], stream)
    kernels.check(status, "adc_scan")
    adc_scan_kernel.launches += 1
    return out_d, out_i


adc_scan_kernel.launches = 0


def adc_sums_kernel(codes, luts):
    """Launch the sums-out entry of ``csrc/adc_scan.cu`` on CUDA tensors
    (same contract as :func:`adc_sums_plain`).  G queries per block with
    their tables in shared memory when G tables fit in ``SMEM_TARGET``,
    else one query per block reading its table through the caches."""
    if not codes.is_cuda:
        raise ValueError("adc_sums kernel needs CUDA tensors")
    dev = codes.device
    n, m = codes.shape
    b, _, K = luts.shape
    if b < 1 or n < 1 or m < 1 or K < 1:
        raise ValueError(f"empty operand: b={b}, n={n}, m={m}, K={K}")
    _check("codes", codes, torch.uint8, (n, m), dev)
    _check("luts", luts, torch.float32, (b, m, K), dev)
    table = 4 * m * K
    G = max(1, min(MAX_G, b, SMEM_TARGET // table))
    lut_smem = G * table <= SMEM_TARGET
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    fn = _sums_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(codes.data_ptr(), luts.data_ptr(), out.data_ptr(), b, n,
                    m, K, G, int(lut_smem), n, stream)
    kernels.check(status, "adc_sums")
    adc_sums_kernel.launches += 1
    return out


adc_sums_kernel.launches = 0

_FN = None
_SUMS_FN = None


def _sums_fn():
    global _SUMS_FN
    if _SUMS_FN is None:
        fn = kernels.load("adc_scan").adc_sums_launch
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        _SUMS_FN = fn
    return _SUMS_FN


def _launch_fn():
    global _FN
    if _FN is None:
        fn = kernels.load("adc_scan").adc_scan_launch
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p] + [i] * 11 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN
