"""Embedding-bag gather-reduce: the CUDA kernel's launcher, its launch plan,
and its plain PyTorch version (``repro.kernels.embedbag.embedbag``).

``embedding_bag_kernel`` launches ``csrc/embedding_bag.cu`` on CUDA
tensors; ``embedding_bag_plain`` computes the same function with torch
ops.  Operands (``ops.embedding_bag`` builds them):

    indices  [N] int32    table row of each lookup (sorted by bag)
    weights  [N] float32  per-sample weight of each lookup
    table    [V, D]       float32 or bfloat16
    spans    (start [B], end [B]) int32: the lookups [start, end) of the
             last run of each bag (``ops.bag_spans``); start == end for an
             empty bag.  The plain version also takes runs (start [R],
             end [R], bag [R]) (``ops.bag_runs``)
    n_bags   int

-> [n_bags, D] in the table's type: for each bag,
``out[bag] = row_0 * w_0; out[bag] += row_i * w_i`` in lookup order (each
multiply and add rounded on its own, the running value rounded to the
table's type after every step, as the Pallas kernel stores its output
block); rows of empty bags are zero.  Kernel and plain version add in the
same order, so they agree bit for bit.

A group of L lanes of the kernel walks the lookups of a range of bags as
one stream, U rows in flight, each lane taking 16-byte (or narrower)
vectors of a row; :func:`plan` picks the variant and the range from the
shapes, the SM count and the variant's resident blocks per SM.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Union

import torch

from repro_torch import kernels

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ITEMSIZE = {0: 4, 1: 2}
THREADS = 256            # threads per block (csrc/embedding_bag.cu)
MAX_BLOCK_BAGS = 2048    # bags a block stages in shared memory (16 KB)
MAX_REGS = 255           # registers a thread may hold on sm_90
# Vector bytes a lane loads, by element size, widest first, and the
# vectors per lane of a pass (CPL) compiled for each width.
VECS = {4: (16, 8, 4), 2: (16, 8, 4, 2)}
CPLS = {16: (1, 2, 4), 8: (1, 2, 4), 4: (1,), 2: (1,)}
# Rows in flight a lane U of the one compiled variant of each (vector
# bytes, CPL).  Other U, timed at the smoke's cases, tied or lost (U = 16,
# one block an SM, lost at every case: PERF.md §6).
ROWS_IN_FLIGHT = {(16, 1): 8, (16, 2): 4, (16, 4): 2, (8, 1): 8, (8, 2): 4,
                  (8, 4): 4, (4, 1): 8, (2, 1): 8}
# The compiled variants (dtype, vector bytes, CPL, U): csrc/embedding_bag.cu's
# EMBEDBAG_VARIANTS lists the same.
VARIANTS = tuple((dt, vb, c, ROWS_IN_FLIGHT[(vb, c)]) for dt in (0, 1)
                 for vb in VECS[ITEMSIZE[dt]] for c in CPLS[vb])


def embedding_bag_plain(indices, weights, table, runs, *, n_bags: int):
    """Plain version of the kernel: step j adds the j-th lookup of every
    run still that long, so each run sums in lookup order.  ``runs`` is
    the kernel's spans (start, end), one per bag, or (start, end, bag) of
    the runs that write.  No ``index_add_``: its atomics on CUDA add in no
    fixed order."""
    if len(runs) == 2:
        start, end = runs
        bag = torch.arange(start.shape[0], device=start.device)
    else:
        start, end, bag = runs
    out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    lens = (end - start).long()
    keep = torch.nonzero(lens > 0).squeeze(1)
    start, bag, lens = start.long()[keep], bag.long()[keep], lens[keep]
    if start.numel() == 0:
        return out
    acc = None
    for j in range(int(lens.max())):
        live = torch.nonzero(lens > j).squeeze(1)
        pos = start[live] + j
        row = table[indices[pos].long()].to(torch.float32) \
            * weights[pos][:, None]
        if acc is None:
            acc = row.to(table.dtype)
        else:
            acc[live] = (acc[live].to(torch.float32) + row).to(table.dtype)
    out[bag] = acc
    return out


def regs_estimate(vec: int, cpl: int, U: int, itemsize: int) -> int:
    """Registers a thread of the (vec, cpl, U) variant needs, by the
    kernel's arrays: U rows of cpl vectors, U (meta, index, weight) of the
    next batch and U (meta, weight) of the current one, cpl * vec /
    itemsize sums, and ~40 for addresses and the walk.  ptxas's count is
    logged beside it (``chip_smoke.py``)."""
    return 40 + U * (cpl * max(1, vec // 4) + 5) + cpl * (vec // itemsize)


def _variant_key(dtype) -> int:
    if dtype not in DTYPES:
        raise ValueError(f"embedding_bag kernel takes float32 or bfloat16 "
                         f"tables, got {dtype}")
    return DTYPES[dtype]


def plan(n_bags: int, n_lookups: int, D: int, dtype, aligned: bool,
         sms: int, per_sm: Union[int, Callable[..., int]], *,
         vec: Optional[int] = None, cpl: Optional[int] = None,
         bags_per_group: Optional[int] = None) -> dict:
    """The launch of ``n_lookups`` lookups into ``n_bags`` bags of a
    [V, D] table of ``dtype`` whose base is 16-byte ``aligned`` (or only
    element-aligned), on a card of ``sms`` SMs:

    * vector bytes ``vec``: the widest of :data:`VECS` that divides the
      row's bytes (the element size where the base is not aligned);
    * vectors a lane takes per pass ``cpl`` and lanes per row ``lanes``:
      one vector a lane and a lane per vector up to 32 of them, wider
      rows 32 lanes and the fewest of :data:`CPLS` that cover the row
      (``passes`` over the row where none does);
    * rows in flight a lane ``U``: the variant's (:data:`ROWS_IN_FLIGHT`);
    * ``bags_per_group`` (consecutive bags a group of ``lanes`` lanes
      walks as one stream): as few as let the card's resident groups take
      every bag in one wave, at most what a block stages.  A second,
      partial wave cost 11 % at Criteo; past one wave the stream's length,
      ``n_lookups`` over the groups, moved nothing (PERF.md), so
      ``n_lookups`` only bounds the plan;
    * ``threads`` per block, ``groups_per_block``, ``grid`` and ``smem``.

    ``per_sm`` is the variant's resident blocks per SM, or a function of
    (dtype, vec, cpl, U, smem) that gives it (the kernel's occupancy
    query).  ``vec``, ``cpl`` and ``bags_per_group`` pin those choices
    (``benchmarks/sweep_embedbag_plan.py`` times the others)."""
    dt = _variant_key(dtype)
    if n_bags < 1 or n_lookups < 0 or D < 1 or sms < 1:
        raise ValueError(f"no plan for n_bags={n_bags}, "
                         f"n_lookups={n_lookups}, D={D}, sms={sms}")
    isz = ITEMSIZE[dt]
    rb = D * isz
    if vec is None:
        vec = next(v for v in VECS[isz] if rb % v == 0
                   and (aligned or v == isz))
    if vec not in VECS[isz] or rb % vec or not (aligned or vec == isz):
        raise ValueError(f"embedding_bag: no {vec}-byte vectors for D={D} "
                         f"({rb}-byte rows, aligned={aligned})")
    nv = rb // vec
    if cpl is None:
        cpl = 1 if nv <= 32 else next(
            (c for c in CPLS[vec] if 32 * c >= nv), CPLS[vec][-1])
    lanes = min(32, -(-nv // cpl))
    U = ROWS_IN_FLIGHT.get((vec, cpl), 0)
    if (dt, vec, cpl, U) not in VARIANTS:
        raise ValueError(f"embedding_bag: no compiled variant dtype={dt}, "
                         f"vec={vec}, cpl={cpl}")
    gpb = THREADS // 32 * (32 // lanes)
    cap = MAX_BLOCK_BAGS // gpb
    blocks = per_sm(dt, vec, cpl, U, 8 * MAX_BLOCK_BAGS) \
        if callable(per_sm) else per_sm
    if blocks < 1:
        raise ValueError(f"embedding_bag: variant {(dt, vec, cpl, U)} has "
                         f"no resident block")
    if bags_per_group is None:
        bags_per_group = min(cap, -(-n_bags // (sms * blocks * gpb)))
    if not 1 <= bags_per_group <= cap:
        raise ValueError(f"embedding_bag: {bags_per_group} bags a group "
                         f"outside [1, {cap}] at {gpb} groups a block")
    block_bags = gpb * bags_per_group
    return dict(dtype=dt, vec=vec, cpl=cpl, lanes=lanes,
                passes=-(-nv // (lanes * cpl)), U=U,
                bags_per_group=bags_per_group,
                bags_per_warp=bags_per_group * (32 // lanes),
                threads=THREADS, groups_per_block=gpb,
                grid=-(-n_bags // block_bags), smem=8 * block_bags,
                blocks_per_sm=blocks,
                regs_estimate=regs_estimate(vec, cpl, U, isz))


def check_plan(p: dict, n_bags: int, D: int, dtype, aligned: bool) -> None:
    """Raise unless ``p`` can launch these operands: a compiled variant of
    the table's type, vectors that divide the row (element-sized where the
    base is not 16-byte aligned), lanes that cover the row in ``passes``,
    bag ranges that give every bag to exactly one group and fit a block's
    shared memory, and registers within a thread's."""
    dt = _variant_key(dtype)
    isz = ITEMSIZE[dt]
    rb = D * isz
    try:
        vec, cpl, lanes, U = p["vec"], p["cpl"], p["lanes"], p["U"]
        bpg, gpb, grid = p["bags_per_group"], p["groups_per_block"], p["grid"]
        nv = rb // vec
        ok = (p["dtype"] == dt and (dt, vec, cpl, U) in VARIANTS
              and rb % vec == 0 and (aligned or vec == isz)
              and 1 <= lanes <= 32 and p["threads"] == THREADS
              and gpb == THREADS // 32 * (32 // lanes)
              and lanes * cpl * p["passes"] >= nv
              > lanes * cpl * (p["passes"] - 1)
              and 1 <= bpg and gpb * bpg <= MAX_BLOCK_BAGS
              and grid * gpb * bpg >= n_bags > (grid - 1) * gpb * bpg
              and p["smem"] == 8 * gpb * bpg
              and regs_estimate(vec, cpl, U, isz) <= MAX_REGS)
    except (KeyError, TypeError, ZeroDivisionError):
        ok = False
    if not ok:
        raise ValueError(f"embedding_bag kernel: plan {p} does not fit "
                         f"n_bags={n_bags}, D={D}, dtype={dtype}, "
                         f"aligned={aligned}")


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"embedding_bag kernel: {name} must be a contiguous {dtype} "
            f"tensor of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


@functools.lru_cache(maxsize=None)
def blocks_per_sm(dtype: int, vec: int, cpl: int, U: int, smem: int) -> int:
    """Resident blocks per SM of a variant with ``smem`` bytes of shared
    memory, from the kernel's occupancy query (cached)."""
    out = ctypes.c_int(0)
    status = _occupancy_fn()(dtype, vec, cpl, U, smem, ctypes.byref(out))
    kernels.check(status, "embedding_bag occupancy")
    return out.value


def kernel_plan(indices, table, n_bags: int) -> dict:
    """The plan :func:`embedding_bag_kernel` launches for these operands."""
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    return plan(n_bags, indices.shape[0], table.shape[1], table.dtype,
                table.data_ptr() % 16 == 0, sms, blocks_per_sm)


def embedding_bag_kernel(indices, weights, table, spans, *, n_bags: int,
                         plan: Optional[dict] = None):
    """Launch the CUDA kernel on CUDA tensors (same contract as
    :func:`embedding_bag_plain`, with the spans of ``ops.bag_spans``) with
    :func:`kernel_plan`'s plan, or with ``plan`` (a :func:`plan` with
    pinned choices, held to the operands by :func:`check_plan`).  The
    kernel writes every row of the output, zeros for empty bags.  Raises
    on anything it does not take."""
    if not table.is_cuda:
        raise ValueError("embedding_bag kernel needs CUDA tensors")
    if table.dtype not in DTYPES:
        raise ValueError(f"embedding_bag kernel takes float32 or bfloat16 "
                         f"tables, got {table.dtype}")
    if len(spans) != 2:
        raise ValueError("embedding_bag kernel takes the spans (start, end) "
                         "of ops.bag_spans, one per bag")
    dev = table.device
    V, D = table.shape
    N = indices.shape[0]
    start, end = spans
    _check("indices", indices, torch.int32, (N,), dev)
    _check("weights", weights, torch.float32, (N,), dev)
    _check("table", table, table.dtype, (V, D), dev)
    _check("span starts", start, torch.int32, (n_bags,), dev)
    _check("span ends", end, torch.int32, (n_bags,), dev)
    out = torch.empty((n_bags, D), dtype=table.dtype, device=dev)
    if n_bags == 0:
        return out
    aligned = table.data_ptr() % 16 == 0
    if plan is None:
        p = kernel_plan(indices, table, n_bags)
    else:
        check_plan(plan, n_bags, D, table.dtype, aligned)
        p = plan
    fn = _launch_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(indices.data_ptr(), weights.data_ptr(), table.data_ptr(),
                    start.data_ptr(), end.data_ptr(), out.data_ptr(), n_bags,
                    D, p["dtype"], p["vec"], p["cpl"], p["U"], p["lanes"],
                    p["bags_per_group"], p["grid"], p["smem"], stream)
    kernels.check(status, "embedding_bag")
    embedding_bag_kernel.launches += 1
    return out


embedding_bag_kernel.launches = 0

_FN = None
_OCC_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        fn = kernels.load("embedding_bag").embedding_bag_launch
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 10 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _occupancy_fn():
    global _OCC_FN
    if _OCC_FN is None:
        fn = kernels.load("embedding_bag").embedding_bag_blocks_per_sm
        i = ctypes.c_int
        fn.argtypes = [i] * 5 + [ctypes.POINTER(i)]
        fn.restype = ctypes.c_int
        _OCC_FN = fn
    return _OCC_FN
