"""ADC code scan: the CUDA kernel's launcher, its launch plan, and its plain
PyTorch version (``repro.kernels.adc_scan.adc_scan``).

``adc_scan_kernel`` launches ``csrc/adc_scan.cu`` on CUDA tensors;
``adc_scan_plain`` computes the same function with torch ops.  Operands:

    codes [n, m]    uint8    packed code table
    luts  [b, m, K] float32  per-query lookup tables (``quant.build_luts``)

-> ([b, C] float32, [b, C] int32): per query the C smallest
(sum_j luts[q, j, codes[i, j]], row) pairs by (dist, row), the sum taken
over j in index order, (+inf, -1) where fewer than C rows exist.  Both
versions add in the same order, so they agree bit for bit.

A block of the kernel owns G queries, whose tables it holds interleaved
in shared memory ([m][K][G]: the G entries of one code adjacent), and a
range of rows; a lane owns the G queries and R rows.  :func:`plan` picks
the variant (G, R, threads) and the buffer size from a cost model of the
shapes, the SM count and the variants' resident blocks per SM, and the
corpus splits by a rule; :func:`interleaved_sums` is the kernel's index
arithmetic in torch.

The TPU kernel takes any C; this one takes C <= ``MAX_C`` (the running
lists live in shared memory) and raises above it.  For larger C,
``ops.adc_scan`` uses the sums-out entry of the same source
(``adc_sums_kernel``: the [b, n] sums, in the same order, into a buffer)
and selects by (dist, row).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.distance_topk.distance_topk import merge_topk_rounds

MAX_C = 1024         # largest C the kernel takes (csrc/adc_scan.cu)
THREADS = 256        # threads per block, but the wide variant's (1024)
MAX_G = 8            # queries per block of the sums-out entry
SMEM_MAX = 232448    # shared memory a block may use on sm_90
SMEM_SM = 233472     # shared memory of one SM
SMEM_RESERVED = 1024  # taken from the SM's for each resident block
SMEM_TARGET = 113 * 1024   # the sums-out entry: two blocks per SM
MAX_SPLITS = 128
# The compiled variants (G, R, threads, tables in shared memory)
# (csrc/adc_scan.cu's scan_variant): those that won on the compressed
# paths' shapes in benchmarks/sweep_adc_plan.py's sweep (its record is in
# PERF.md) and those small batches and large tables need.
VARIANTS = ((4, 1, THREADS, True), (1, 1, THREADS, True),
            (1, 2, 1024, True), (1, 1, THREADS, False))
# Cost constants (cycles of one SM), fitted to
# ``benchmarks/sweep_adc_plan.py``'s times on an H100 (:func:`plan_cost`'s
# terms): per variant (G, R, threads), the cycles 32 lookups take and the
# resident blocks per SM they were measured at (PQ m = 16 at b = 4,096,
# C = 10; the 1,024-thread one on int8's 128 KB table), a variant with
# fewer resident blocks taking (measured / resident) ** OCCUPANCY_POWER
# times as long; a block's start (its table load and list set-up); one
# compare-exchange of a merging warp.  Bank conflicts alone (the expected
# largest bank load of each phase, on uniform codes) would give 2.54 /
# 3.15 cycles at G = 4 / 1.
LOOKUP_CYCLES = {(4, 1, THREADS): (3.04, 2), (1, 1, THREADS): (4.24, 4),
                 (1, 2, 1024): (5.4, 1)}
OCCUPANCY_POWER = 0.6
CACHE_LOOKUP_CYCLES = 12.0   # the cache route (L1 / L2): it has no rival
BLOCK_CYCLES = 46_000
CAS_CYCLES = 107


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


def tile_rows(R: int, threads: int = THREADS) -> int:
    """Rows one tile of a variant with R rows a lane covers."""
    return R * threads


def smem_bytes(G: int, m: int, K: int, P: int, BUF: int,
               lut_smem: bool) -> int:
    """Dynamic shared memory of a block: tables, lists, buffers, counts."""
    return (4 * G * m * K if lut_smem else 0) + 8 * G * (P + BUF) + 4 * G


def model_blocks_per_sm(G: int, R: int, threads: int, lut_smem: bool,
                        smem: int) -> int:
    """Resident blocks per SM as the launch bounds promise them (two blocks'
    registers for R <= 2 at 256 threads, else one) and shared memory
    allows; the kernel's wrapper asks the occupancy calculator instead."""
    regs = 2 if R <= 2 and threads == THREADS else 1
    return max(0, min(2048 // threads, regs,
                      SMEM_SM // (smem + SMEM_RESERVED)))


def inserts(rows: int, C: int) -> float:
    """Expected pairs a query's scan of ``rows`` rows in random order
    inserts into a list of C: every row while the list fills, then row i
    with probability C / i."""
    return float(rows) if rows <= C else C * (1.0 + math.log(rows / C))


def merge_cycles(BUF: int, P: int) -> float:
    """One merge of a full buffer into a list of P (``warp_merge``):
    compare-exchanges a lane does, times ``CAS_CYCLES``."""
    lb, lp = int(math.log2(BUF)), int(math.log2(P))
    cas = BUF // 2 * lb * (lb + 1) // 2 + P // 2 * lp
    if BUF < P:
        cas += BUF // 2 * lb
    return cas / 32 * CAS_CYCLES


def plan_cost(b: int, n: int, m: int, C: int, sms: int, per_sm: int,
              G: int, R: int, BUF: int, splits: int,
              lut_smem: bool = True, threads: int = THREADS) -> float:
    """Modelled cycles of a launch on the busiest SM, its blocks taken one
    after another: each block's lookups at the variant's
    ``LOOKUP_CYCLES`` per 32 (padded queries of the tail group counted;
    slower where fewer than the measured blocks are resident), its start,
    and its merges (``inserts`` / free buffer slots, plus the last); then
    the merge of the splits."""
    P = _pow2(C)
    TR = tile_rows(R, threads)
    rows = -(-(-(-n // splits)) // TR) * TR
    blocks = -(-(-(-b // G) * splits) // sms)
    if lut_smem:
        lc, fit_per_sm = LOOKUP_CYCLES[(G, R, threads)]
        lc *= max(1.0, fit_per_sm / per_sm) ** OCCUPANCY_POWER
    else:
        lc = CACHE_LOOKUP_CYCLES
    merges = inserts(min(rows, n), C) / max(1, BUF - TR + 1) + 1
    return blocks * (rows * m * G * lc / 32 + BLOCK_CYCLES
                     + merges * merge_cycles(BUF, P)) + (
        C * splits * 8 if splits > 1 else 0)


def split_rule(b: int, n: int, G: int, TR: int, sms: int,
               per_sm: int) -> tuple:
    """(splits, rows): as many corpus ranges as the query groups' blocks
    fit in one wave of ``per_sm`` resident blocks on every SM (at least
    one), each at least four tiles of ``TR`` rows, at most
    ``MAX_SPLITS``; rows a range in whole tiles.
    ``benchmarks/sweep_adc_plan.py`` times it against 1 to 128 ranges: at
    b >= 4,096 it gives one range, the fastest there; at b = 1 .. 64 two
    waves (the parent's rule) ran 14-25 % behind the best count at five
    of six shapes, and a range more than one wave holds starts a second,
    nearly empty wave (PERF.md)."""
    groups = -(-b // G)
    splits = max(1, min(sms * per_sm // groups, MAX_SPLITS,
                        -(-n // (4 * TR))))
    rows = -(-(-(-n // splits)) // TR) * TR
    return -(-n // rows), rows


def plan(b: int, n: int, m: int, K: int, C: int, sms: int, *,
         occupancy: Callable[[int, int, int, bool, int], int] =
         model_blocks_per_sm, G: Optional[int] = None,
         R: Optional[int] = None, threads: Optional[int] = None,
         splits: Optional[int] = None) -> dict:
    """The launch of the scan: one of :data:`VARIANTS` -- queries per
    block G (the tables interleaved in shared memory; G = 1 is one query's
    table, and a table too large for shared memory even alone is read
    through the caches), rows per lane R, threads per block -- the list
    size P = pow2(C), the buffer size BUF (the largest power of two up to
    max(P, two tiles' rows) that fits beside the tables and lists without
    costing a resident block, two tiles' rows or more where they fit, else
    down to one tile's) and the corpus cut into ``splits`` ranges of
    ``rows`` rows by :func:`split_rule`.

    Of the variants the least :func:`plan_cost` wins (the larger G among
    equals); ``occupancy(G, R, threads, lut_smem, smem)`` gives resident
    blocks per SM.  ``G``, ``R``, ``threads`` and ``splits`` pin those
    choices (``benchmarks/sweep_adc_plan.py`` times the others)."""
    return dict(_plan(b, n, m, K, C, sms, occupancy, G, R, threads, splits))


@functools.lru_cache(maxsize=256)
def _plan(b, n, m, K, C, sms, occupancy, G, R, threads, splits) -> dict:
    if b < 1 or n < 1 or m < 1 or K < 1 or not 1 <= C <= MAX_C or sms < 1 \
            or not (splits is None or 1 <= splits <= MAX_SPLITS):
        raise ValueError(f"no plan for b={b}, n={n}, m={m}, K={K}, C={C}, "
                         f"sms={sms}, splits={splits}")
    P = _pow2(C)
    lut_smem = smem_bytes(1, m, K, P, tile_rows(1), True) <= SMEM_MAX
    best = None
    for g, r, nt, sm in VARIANTS:
        if sm != lut_smem or (G is None and g >= 2 * b) or \
                G not in (None, g) or R not in (None, r) or \
                threads not in (None, nt):
            continue
        TR = tile_rows(r, nt)
        bufs = []                      # (BUF, smem, resident blocks)
        BUF = max(P, 2 * TR)
        while BUF >= TR:
            smem = smem_bytes(g, m, K, P, BUF, lut_smem)
            if smem <= SMEM_MAX:
                bufs.append((BUF, smem, occupancy(g, r, nt, lut_smem, smem)))
            BUF //= 2
        # two tiles' rows or more where they fit, else down to one; of
        # those, the largest buffer that costs no resident block
        bufs = [x for x in bufs if x[0] >= 2 * TR] or bufs
        top = max((o for _, _, o in bufs), default=0)
        if top < 1:
            continue
        buf, smem, per_sm = next(x for x in bufs if x[2] == top)
        if splits is None:
            s, rows = split_rule(b, n, g, TR, sms, per_sm)
        else:
            rows = -(-(-(-n // splits)) // TR) * TR
            s = -(-n // rows)
            if s != splits:            # no whole-tile ranges of this count
                continue
        cost = plan_cost(b, n, m, C, sms, per_sm, g, r, buf, s, lut_smem, nt)
        key = (cost, -g, r, nt)
        if best is None or key < best[0]:
            best = (key, dict(
                G=g, R=r, threads=nt, lut_smem=lut_smem, P=P, BUF=buf,
                tile_rows=TR, splits=s, rows=rows, smem=smem,
                blocks_per_sm=per_sm, cost_cycles=cost))
    if best is None:
        raise ValueError(f"no variant fits: b={b}, n={n}, m={m}, K={K}, "
                         f"C={C}, G={G}, R={R}, threads={threads}, "
                         f"splits={splits}")
    return best[1]


def check_plan(p: dict, b: int, n: int, m: int, K: int, k: int) -> None:
    """Raise unless ``p`` can launch these operands: a compiled variant,
    whole-tile ranges that cover the n rows with none empty, a list of at
    least ``k``, and shared memory that fits (the launcher checks the
    powers of two)."""
    v = (p["G"], p["R"], p["threads"], p["lut_smem"])
    TR = tile_rows(p["R"], p["threads"])
    ok = (v in VARIANTS and 1 <= p["splits"] <= MAX_SPLITS
          and p["rows"] % TR == 0
          and p["splits"] * p["rows"] >= n > (p["splits"] - 1) * p["rows"]
          and p["P"] >= k and p["BUF"] >= TR
          and smem_bytes(p["G"], m, K, p["P"], p["BUF"], p["lut_smem"])
          <= SMEM_MAX)
    if not ok:
        raise ValueError(f"adc_scan kernel: plan {p} does not fit b={b}, "
                         f"n={n}, m={m}, K={K}, C={k}")


def interleaved_sums(codes: torch.Tensor, luts: torch.Tensor, *, q0: int,
                     G: int, R: int, row_begin: int, row_end: int,
                     threads: int = THREADS) -> torch.Tensor:
    """The [G, row_end - row_begin] sums one block of the (G, R, threads)
    variant computes for queries q0 .. q0 + G - 1, by the kernel's index
    arithmetic: the transposing load (word e of query g's table to word
    e * G + g of the shared table; zeros past the tail group's last query),
    thread tid's row t0 + r * threads + tid of each tile t0, and lookups
    at word ((j * K + c) * G + g), added in subspace order.  Raises unless
    the lanes compute every (query, row) of the block exactly once."""
    n, m = codes.shape
    b, _, K = luts.shape
    gq = min(G, b - q0)
    tab = torch.zeros((m * K, G), dtype=luts.dtype, device=luts.device)
    tab[:, :gq] = luts[q0:q0 + gq].reshape(gq, m * K).T
    tab = tab.reshape(-1)
    tid = torch.arange(threads, device=luts.device)
    t0 = torch.arange(row_begin, row_end, R * threads, device=luts.device)
    row = (t0[:, None, None] + torch.arange(R, device=luts.device)[
        None, :, None] * threads + tid[None, None, :]).reshape(-1)
    live = row < row_end
    rows_codes = codes[row.clamp(max=n - 1)].long()            # [lanes, m]
    out = torch.zeros((G, row_end - row_begin), dtype=luts.dtype,
                      device=luts.device)
    seen = torch.zeros(out.shape, dtype=torch.int64, device=luts.device)
    for g in range(G):
        acc = torch.zeros(row.shape, dtype=luts.dtype, device=luts.device)
        for j in range(m):
            acc = acc + tab[(j * K + rows_codes[:, j]) * G + g]
        at = (torch.full_like(row[live], g), (row - row_begin)[live])
        out[at] = acc[live]
        seen.index_put_(at, torch.ones_like(at[0]), accumulate=True)
    if not bool((seen == 1).all()):
        raise RuntimeError("interleaved_sums: the lanes do not cover the "
                           "block's (query, row) pairs once each")
    return out


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"adc_scan kernel: {name} must be a contiguous {dtype} tensor "
            f"of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


@functools.lru_cache(maxsize=None)
def blocks_per_sm(G: int, R: int, threads: int, lut_smem: bool,
                  smem: int) -> int:
    """Resident blocks per SM of the (G, R, threads) variant with ``smem``
    bytes of shared memory, from the kernel's occupancy query (cached)."""
    out = ctypes.c_int(0)
    status = _occupancy_fn()(G, R, threads, int(lut_smem), smem,
                             ctypes.byref(out))
    kernels.check(status, "adc_scan occupancy")
    return out.value


def kernel_plan(codes, luts, k: int) -> dict:
    """The plan :func:`adc_scan_kernel` launches for these operands."""
    n, m = codes.shape
    b, _, K = luts.shape
    sms = torch.cuda.get_device_properties(codes.device).multi_processor_count
    return plan(b, n, m, K, k, sms, occupancy=blocks_per_sm)


def adc_scan_kernel(codes, luts, *, k: int, plan: Optional[dict] = None):
    """Launch the CUDA kernel on CUDA tensors (same contract as
    :func:`adc_scan_plain`) with :func:`kernel_plan`'s plan, or with
    ``plan`` (a :func:`plan` with pinned choices, held to the operands by
    :func:`check_plan`).  Raises on anything it does not take, including
    C = ``k`` above :data:`MAX_C`."""
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
    if plan is None:
        p = kernel_plan(codes, luts, k)
    else:
        check_plan(plan, b, n, m, K, k)
        p = plan
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
                    b, n, m, K, k, p["P"], p["BUF"], p["G"], p["R"],
                    p["threads"], int(p["lut_smem"]), p["splits"], p["rows"],
                    stream)
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
_OCC_FN = None


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
        fn.argtypes = [p, p, p, p, p, p] + [i] * 13 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _occupancy_fn():
    global _OCC_FN
    if _OCC_FN is None:
        fn = kernels.load("adc_scan").adc_scan_blocks_per_sm
        i = ctypes.c_int
        fn.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
        fn.restype = ctypes.c_int
        _OCC_FN = fn
    return _OCC_FN
