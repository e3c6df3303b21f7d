"""Streaming fused distance + top-k: the CUDA kernel's launcher, its launch
plan, and its plain PyTorch version (``repro.kernels.distance_topk.
distance_topk``).

``stream_topk_kernel`` launches ``csrc/stream_topk.cu`` on CUDA tensors;
``stream_topk_plain`` computes the same function with torch ops, tile by
tile, in the reference's arithmetic.  ``ops.stream_topk`` picks one by the
tensors' device: the plain version only for CPU tensors, the kernel (or an
error) for CUDA tensors.

The kernel's blocks own a tile of ``rows`` queries (128, or 64 where two
blocks of 128 would not fit an SM's shared memory at this k) and a range of
whole 128-row corpus tiles; :func:`launch_plan` picks the variant and the
ranges from the shapes, the SM count and the variant's resident blocks per
SM (the occupancy calculator's), and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.kernels.distance.distance import distance_epilogue

NEG_ONE = -1
MODES = {"l2sq": 0, "ip": 1, "cos": 2}
# csrc/stream_topk.cu and csrc/fp32_tile.cuh
ROWS = (128, 64)    # query rows per tile: the two variants
BN = 128            # corpus rows per tile
BD = 8              # contraction chunk
CAP = 16            # survivors buffered per query and round
MAX_SPLITS = 128    # csrc/topk_list.cuh
SMEM_BLOCK = 232_448     # shared memory one block may have (H100)
SMEM_SM = 233_472        # shared memory of one SM (H100)
SMEM_RESERVED = 1_024    # taken from the SM's for each resident block


def merge_topk_rounds(cand_d: torch.Tensor, cand_i: torch.Tensor, k: int):
    """The k smallest (dist, id) pairs per row from [bq, m] candidates.

    The reference runs k rounds of (min, first argmin, mask); a stable sort
    by distance picks the same entries in the same order (equal distances
    in position order).  Ids are -1 where the distance is not finite, i.e.
    where fewer than k finite candidates exist.
    """
    vals, pos = torch.sort(cand_d, dim=1, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    ids = torch.gather(cand_i, 1, pos)
    alive = torch.isfinite(vals)
    return vals, torch.where(alive, ids, torch.full_like(ids, NEG_ONE))


def stream_topk_plain(Q, X, qsq, xsq, *, mode: str, k: int,
                      bn: int = 16384):
    """Plain version of the kernel: corpus tiles of ``bn`` rows, one fp32
    matmul per tile, the shared epilogue, and a fold of (running k ∪ tile)
    through ``merge_topk_rounds``.  The running state precedes the tile and
    ids ascend within it, so ties go to the smaller id as in the kernel.

    Q [nq, d] f32, X [n, d] f32, qsq [nq] f32, xsq [n] f32 (norms or
    0/+inf penalty) -> ([nq, k] f32, [nq, k] int32).
    """
    nq, n = Q.shape[0], X.shape[0]
    vals = torch.full((nq, k), float("inf"), dtype=torch.float32,
                      device=Q.device)
    ids = torch.full((nq, k), NEG_ONE, dtype=torch.int32, device=Q.device)
    qn = qsq.reshape(nq, 1)
    for s in range(0, n, bn):
        e = min(s + bn, n)
        cross = Q @ X[s:e].T
        d = distance_epilogue(cross, qn, xsq[s:e].reshape(1, -1), mode)
        tile_ids = torch.arange(s, e, dtype=torch.int32,
                                device=Q.device).expand(nq, -1)
        vals, ids = merge_topk_rounds(torch.cat([vals, d], dim=1),
                                      torch.cat([ids, tile_ids], dim=1), k)
    return vals, ids


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"stream_topk kernel: {name} must be a contiguous {dtype} tensor "
            f"of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def smem_bytes(rows: int, k: int) -> int:
    """Shared bytes of a block of ``rows`` query rows at this k (the
    kernel's ``smem_bytes``): the double-buffered k-major stage buffers,
    the query and corpus norms, and per query row its list of k (dist, id)
    pairs, its buffer of ``CAP`` pairs and a count."""
    stage = 2 * BD * ((rows + 4) + (BN + 4))
    return 4 * (stage + rows + 2 * BN) + rows * (8 * k + 8 * CAP + 4)


def query_rows(nq: int, k: int) -> int:
    """The variant: 128 query rows a tile where there are more than 64
    queries and two such blocks fit an SM's shared memory (k <= 78), else
    64 (every k <= 256 fits one block of 64)."""
    two = 2 * (smem_bytes(128, k) + SMEM_RESERVED) <= SMEM_SM
    return 128 if nq > 64 and two else 64


class Plan(NamedTuple):
    rows: int             # query rows per tile (the variant)
    splits: int           # corpus ranges per query tile (grid.y)
    rows_per_split: int   # corpus rows per range, whole BN tiles
    smem: int             # shared bytes per block


# The plan's cost model, in units of one 128-row tile's time with two
# blocks sharing an SM (benchmarks/sweep_stream_plan.py measures the times
# it was fitted to; PERF.md, PR 18):
TILE_TIME = {128: 1.0, 64: 0.72}   # a tile of the variant
ALONE = 0.57              # a block alone on its SM: its tile time
INSERT_TIME = (0.0088, 0.00177)    # one insert: a + b * ceil(k / 32)


def inserts(k: int, m: int) -> float:
    """Expected insertions into a list of the k smallest of m candidates
    that come in random order: every one of the first k, then candidate
    i with probability k / i."""
    return float(m) if m <= k else k * (1.0 + math.log(m / k))


def _shared(blocks_per_sm: int) -> float:
    return ALONE if blocks_per_sm == 1 else blocks_per_sm / 2


def plan_cost(nq: int, n: int, k: int, sms: int, per_sm: int, rows: int,
              splits: int) -> float:
    """Modelled time of a launch, in 128-row tiles: ``q_tiles * splits``
    blocks run in waves of ``sms * per_sm``; a block's time is its tiles
    (at the rate of the blocks sharing its SM) plus its inserts (one warp
    per query: rows / 8 queries a warp, ``inserts(k, range)`` each), which
    the splits multiply."""
    tiles = -(-n // BN)
    per = -(-tiles // splits)
    full, rest = divmod(-(-nq // rows) * -(-tiles // per), sms * per_sm)
    work = per * TILE_TIME[rows]
    one = INSERT_TIME[0] + INSERT_TIME[1] * -(-k // 32)
    ins = rows / 8 * inserts(k, per * BN) * one
    cost = full * (work * _shared(per_sm) + ins)
    if rest:
        cost += work * _shared(min(per_sm, -(-rest // sms))) + ins
    return cost


@functools.lru_cache(maxsize=256)
def launch_plan(nq: int, n: int, k: int, sms: int, per_sm: int) -> Plan:
    """The launch of ``nq`` queries against ``n`` rows at this k on a card
    of ``sms`` SMs that keeps ``per_sm`` blocks of the variant resident:
    the variant of :func:`query_rows`, and the corpus cut into ranges of
    whole tiles, as many as give the least :func:`plan_cost` (the fewest
    among equals)."""
    if nq < 1 or n < 1 or not 1 <= k <= kernels.MAX_K or sms < 1 \
            or per_sm < 1:
        raise ValueError(f"no plan for nq={nq}, n={n}, k={k}, sms={sms}, "
                         f"per_sm={per_sm}")
    rows = query_rows(nq, k)
    tiles = -(-n // BN)
    best = None
    for s in range(1, min(MAX_SPLITS, tiles) + 1):
        per = -(-tiles // s)
        if -(-tiles // per) != s:       # the same ranges as fewer splits
            continue
        cost = plan_cost(nq, n, k, sms, per_sm, rows, s)
        if best is None or cost < best[0]:
            best = (cost, s, per)
    _, splits, per = best
    return Plan(rows, splits, per * BN, smem_bytes(rows, k))


@functools.lru_cache(maxsize=None)
def blocks_per_sm(rows: int, k: int, vec: bool, mode: str) -> int:
    """Resident blocks per SM of the variant at this k, from the kernel's
    occupancy query (cached: it depends on nothing else)."""
    out = ctypes.c_int(0)
    status = _lib().stream_topk_blocks_per_sm(rows, k, int(vec), MODES[mode],
                                              ctypes.byref(out))
    kernels.check(status, "stream_topk occupancy")
    if out.value < 1:
        raise RuntimeError(f"stream_topk: no block of {rows} query rows "
                           f"fits an SM at k={k}")
    return out.value


def kernel_plan(Q, X, k: int, mode: str) -> Plan:
    """The plan :func:`stream_topk_kernel` launches for these operands."""
    nq, d = Q.shape
    vec = d % 4 == 0 and Q.data_ptr() % 16 == 0 and X.data_ptr() % 16 == 0
    sms = torch.cuda.get_device_properties(Q.device).multi_processor_count
    per_sm = blocks_per_sm(query_rows(nq, k), k, vec, mode)
    return launch_plan(nq, X.shape[0], k, sms, per_sm)


def stream_topk_kernel(Q, X, qsq, xsq, *, mode: str, k: int,
                       plan: Plan | None = None):
    """Launch the CUDA kernel on CUDA tensors (same contract as
    :func:`stream_topk_plain`) with :func:`kernel_plan`'s plan, or with
    ``plan`` (``benchmarks/sweep_stream_plan.py`` times others).  Raises on
    anything it does not take."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not 1 <= k <= kernels.MAX_K:
        raise ValueError(f"stream_topk kernel takes 1 <= k <= "
                         f"{kernels.MAX_K}, got k={k}")
    if not Q.is_cuda:
        raise ValueError("stream_topk kernel needs CUDA tensors")
    dev = Q.device
    nq, d = Q.shape
    n = X.shape[0]
    if nq < 1 or n < 1 or d < 1:
        raise ValueError(f"empty operand: nq={nq}, n={n}, d={d}")
    _check("Q", Q, torch.float32, (nq, d), dev)
    _check("X", X, torch.float32, (n, d), dev)
    _check("qsq", qsq, torch.float32, (nq,), dev)
    _check("xsq", xsq, torch.float32, (n,), dev)
    with torch.cuda.device(dev):
        if plan is None:
            plan = kernel_plan(Q, X, k, mode)
        elif plan.rows not in ROWS or plan.smem != smem_bytes(plan.rows, k) \
                or not 1 <= plan.splits <= MAX_SPLITS \
                or plan.rows_per_split % BN \
                or (plan.splits - 1) * plan.rows_per_split >= n \
                or plan.splits * plan.rows_per_split < n:
            raise ValueError(f"stream_topk kernel: {plan} does not cover "
                             f"n={n} at k={k}")
        part_d = torch.empty((plan.splits, nq, k), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((plan.splits, nq, k), dtype=torch.int32,
                             device=dev)
        out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _launch_fn()(
            Q.data_ptr(), X.data_ptr(), qsq.data_ptr(), xsq.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), nq, n, d, k, MODES[mode], plan.rows,
            plan.splits, plan.rows_per_split, stream)
    kernels.check(status, "stream_topk")
    stream_topk_kernel.launches += 1
    return out_d, out_i


stream_topk_kernel.launches = 0

_FN = None


def _lib():
    lib = kernels.load("stream_topk")
    lib.stream_topk_blocks_per_sm.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.stream_topk_blocks_per_sm.restype = ctypes.c_int
    lib.stream_topk_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.stream_topk_smem_bytes.restype = ctypes.c_longlong
    return lib


def _launch_fn():
    global _FN
    if _FN is None:
        fn = _lib().stream_topk_launch
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN
