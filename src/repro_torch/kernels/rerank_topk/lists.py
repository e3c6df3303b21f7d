"""The fused rerank's list entry: IVF's probed lists scanned list by list
(``csrc/rerank_topk.cu``, ``rerank_lists_launch`` + ``rerank_merge_launch``).

It computes what the generic entry computes on the window [b, P lists x M
rows] of :func:`list_window` (the window of ``ann/ivf.py::probe_window``),
without building that window: the (query, probe slot) pairs are sorted by
list (:func:`pair_build`), and a block owns one list and a chunk of
``BM`` of its queries, with the list's contiguous rows of the
cluster-major corpus streaming through kernel 1's tile.  Each block writes
one partial list per (query, probe slot), and a merge pass keeps each
query's kk best distinct ids.  :func:`launch_plan` sizes the launch from
the shapes alone.

Operands:

    Q        [b, d] float32       queries (unit rows for cos)
    qsq      [b]    float32       squared query norms (l2sq; zeros for cos)
    X        [n, d] float32       the cluster-major corpus
    xsq      [n]    float32       its squared norms (l2sq), else None
    probes   [b, P] int           each query's P probed lists
    starts, sizes [n_lists] int32 each list's first row and length
    row_ids  [n]    int32         output id of each row
    row_live [n]    uint8 / bool  optional: rows that may be returned
    M        int                  the window's per-list width
    n_probes None, int or 0-d tensor: probe slots >= n_probes are dead
    scan     None, int or 0-d tensor: a list's rows past max(scan, 1) are
             skipped

-> ([b, kk] float32, [b, kk] int32), kk = min(k, P * M).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.kernels.rerank_topk.rerank_topk import rerank_topk_plain

MODES = {"l2sq": 0, "cos": 1}
# csrc/rerank_topk.cu and csrc/fp32_tile.cuh
BM = 64             # query rows per block
BN = 128            # corpus rows per tile
BD = 8              # contraction chunk
CAP = 16            # survivors buffered per query and round
SMEM_BLOCK = 232_448     # shared memory one block may have (H100)


def smem_bytes(kp: int) -> int:
    """Shared bytes of a list block with partial lists of ``kp`` pairs
    (the kernel's ``list_smem_bytes``): kernel 1's stage buffers and
    norms, the tile's ids, each query row's query and pair index, and per
    row its list, its buffer of ``CAP`` pairs and a count."""
    stage = 2 * BD * ((BM + 4) + (BN + 4))
    return 4 * (stage + BM + 2 * BN) + 4 * (2 * BN + 2 * BM) \
        + BM * (8 * kp + 8 * CAP + 4)


class ListPlan(NamedTuple):
    kp: int               # pairs per partial list
    kk: int               # pairs per query out
    grid_x: int           # blocks: the bound on (list, chunk)s
    smem: int             # shared bytes per block


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, P: int, n_lists: int, M: int, k: int) -> ListPlan:
    """The launch for ``b`` queries of ``P`` probe slots each over
    ``n_lists`` lists, a window of ``M`` rows per list, at this k:
    kk = min(k, P * M), at most ``kernels.MAX_K`` (above, the wrapper
    takes the distances-out route); kp = min(kk, M), since a partial list
    never holds more than its list's rows; a grid of one block per list
    and one more per ``BM`` pairs, the most (list, chunk)s the pairs can
    make."""
    if b < 1 or P < 1 or n_lists < 1 or M < 1 \
            or not 1 <= min(k, P * M) <= kernels.MAX_K:
        raise ValueError(f"no list plan for b={b}, P={P}, n_lists={n_lists}"
                         f", M={M}, k={k}")
    kk = min(k, P * M)
    kp = min(kk, M)
    return ListPlan(kp, kk, n_lists + -(-b * P // BM), smem_bytes(kp))


class Pairs(NamedTuple):
    order: torch.Tensor    # [b P] int32: pair q P + p, sorted by list
    counts: torch.Tensor   # [n_lists] int32: live pairs per list
    pstart: torch.Tensor   # [n_lists] int32: a list's first in ``order``
    perm: torch.Tensor     # [n_lists] int32: lists, longest first
    cum: torch.Tensor      # [n_lists] int32: blocks through perm[i]


def pair_build(probes: torch.Tensor, n_probes, n_lists: int,
               sizes: torch.Tensor) -> Pairs:
    """The list pass's operands, on the probes' device, without reading a
    device value on the host: one key per (query, probe slot), the probed
    list where ``slot < n_probes`` (every slot when ``n_probes`` is None)
    and the sentinel ``n_lists`` where not; the pairs sorted stably by key;
    each list's first pair and count (binary searches in the sorted keys:
    ``torch.bincount`` on a card reads the largest key on the host); the
    lists longest first, and the running count of ``ceil(count / BM)``
    blocks in that order."""
    b, P = probes.shape
    dev = probes.device
    keys = probes.to(torch.int64)
    if n_probes is not None:
        slot = torch.arange(P, device=dev)
        live = slot < torch.as_tensor(n_probes, device=dev)
        keys = torch.where(live[None, :], keys,
                           torch.full_like(keys, n_lists))
    keys, order = torch.sort(keys.reshape(-1), stable=True)
    bounds = torch.searchsorted(keys, torch.arange(n_lists + 1, device=dev))
    pstart = bounds[:-1]
    counts = bounds[1:] - pstart
    perm = torch.sort(sizes.to(torch.int64), descending=True,
                      stable=True).indices
    cum = torch.cumsum((counts[perm] + BM - 1) // BM, 0)
    i32 = torch.int32
    return Pairs(order.to(i32), counts.to(i32), pstart.to(i32),
                 perm.to(i32), cum.to(i32))


def list_window(probes, starts, sizes, M: int, n: int, *, n_probes=None,
                scan=None, row_live=None):
    """The window the list entry stands for: candidate rows [b, P * M]
    (M consecutive rows from each probed list's start, clamped to the
    corpus) and their validity (inside the list, the slot below
    ``n_probes``, the offset below ``max(scan, 1)``, the row live), in the
    expression trees of ``repro.ann.ivf.search``."""
    dev = probes.device
    b, P = probes.shape
    st = starts[probes]                                  # [b, P]
    sz = sizes[probes]
    offs = torch.arange(M, dtype=torch.int32, device=dev)
    cand = st[..., None] + offs[None, None, :]           # [b, P, M]
    valid = offs[None, None, :] < sz[..., None]
    if n_probes is not None:
        live = torch.arange(P, dtype=torch.int32, device=dev) \
            < torch.as_tensor(n_probes, device=dev)
        valid = valid & live[None, :, None]
    if scan is not None:
        valid = valid & (offs[None, None, :] < torch.clamp_min(
            torch.as_tensor(scan, device=dev), 1))
    cand = torch.clamp_max(cand, n - 1).reshape(b, -1).to(torch.int32)
    valid = valid.reshape(b, -1)
    if row_live is not None:
        valid = valid & row_live.to(torch.bool)[cand.long()]
    return cand, valid


def rerank_lists_plain(Q, qsq, X, xsq, probes, starts, sizes, row_ids, *,
                       M: int, mode: str, k: int, n_probes=None, scan=None,
                       row_live=None):
    """Plain version of the list entry: its definition, the window of
    :func:`list_window` through the generic entry's plain version."""
    from repro_torch.kernels.rerank_topk.ops import kernel_operands

    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    cand, valid = list_window(probes, starts, sizes, M, X.shape[0],
                              n_probes=n_probes, scan=scan,
                              row_live=row_live)
    metric = "euclidean" if mode == "l2sq" else "angular"
    ops = kernel_operands(Q, X, qsq.reshape(-1, 1) if mode == "l2sq"
                          else None, xsq, cand, ~valid, row_ids, metric,
                          min(k, cand.shape[1]))
    return rerank_topk_plain(**ops)


def _check(name, t, dtypes, shape, device):
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"rerank_lists kernel: {name} must be a contiguous {dtypes[0]} "
            f"tensor of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def _scalar(value, default: int, device):
    """(pointer, host value) of a knob: a device int32 scalar's pointer
    (the kernels read it; no host sync), or 0 and the int."""
    if isinstance(value, torch.Tensor):
        t = value.to(device=device, dtype=torch.int32).reshape(())
        return t, t.data_ptr(), default
    return None, 0, default if value is None else int(value)


@functools.lru_cache(maxsize=None)
def blocks_per_sm(kp: int, vec: bool, mode: str) -> int:
    """Resident list blocks per SM, from the kernel's occupancy query."""
    out = ctypes.c_int(0)
    status = _lib().rerank_lists_blocks_per_sm(kp, int(vec), MODES[mode],
                                               ctypes.byref(out))
    kernels.check(status, "rerank_lists occupancy")
    return out.value


def list_pass(Q, qsq, X, xsq, row_ids, row_live, starts, sizes, pairs,
              plan: ListPlan, *, M: int, mode: str, scan=None):
    """The list kernel alone: the [b, P, kp] partial lists."""
    dev = Q.device
    b, d = Q.shape
    P = pairs.order.shape[0] // b
    part_d = torch.empty((b, P, plan.kp), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, P, plan.kp), dtype=torch.int32, device=dev)
    scan_t, scan_ptr, scan_host = _scalar(scan, M, dev)
    if scan_t is None:
        scan_host = max(1, scan_host)
    live_ptr = 0 if row_live is None else row_live.data_ptr()
    xsq_ptr = 0 if xsq is None else xsq.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _lists_fn()(
            Q.data_ptr(), qsq.data_ptr(), X.data_ptr(), xsq_ptr,
            row_ids.data_ptr(), live_ptr, starts.data_ptr(),
            sizes.data_ptr(), pairs.order.data_ptr(),
            pairs.pstart.data_ptr(), pairs.counts.data_ptr(),
            pairs.perm.data_ptr(), pairs.cum.data_ptr(), scan_ptr,
            part_d.data_ptr(), part_i.data_ptr(), b, d, P,
            starts.shape[0], M, scan_host, plan.kp, plan.grid_x, MODES[mode],
            stream)
    kernels.check(status, "rerank_lists")
    del scan_t
    return part_d, part_i


def merge_pass(part_d, part_i, plan: ListPlan, n_probes=None):
    """The merge kernel alone: each query's live partial lists -> its kk
    best distinct ids."""
    dev = part_d.device
    b, P = part_d.shape[:2]
    out_d = torch.empty((b, plan.kk), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, plan.kk), dtype=torch.int32, device=dev)
    np_t, np_ptr, np_host = _scalar(n_probes, P, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _merge_fn()(
            part_d.data_ptr(), part_i.data_ptr(), np_ptr, out_d.data_ptr(),
            out_i.data_ptr(), b, P, plan.kp, plan.kk, np_host, stream)
    kernels.check(status, "rerank_merge")
    del np_t
    return out_d, out_i


def rerank_lists_kernel(Q, qsq, X, xsq, probes, starts, sizes, row_ids, *,
                        M: int, mode: str, k: int, n_probes=None, scan=None,
                        row_live=None):
    """Launch the list entry on CUDA tensors (same contract as
    :func:`rerank_lists_plain`): the pair build, the list pass and the
    merge pass.  Raises on anything it does not take."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not Q.is_cuda:
        raise ValueError("rerank_lists kernel needs CUDA tensors")
    dev = Q.device
    b, d = Q.shape
    n = X.shape[0]
    P = probes.shape[1]
    n_lists = starts.shape[0]
    if b < 1 or P < 1 or n < 1 or d < 1 or M < 1:
        raise ValueError(f"empty operand: b={b}, P={P}, n={n}, d={d}, M={M}")
    f32, i32 = (torch.float32,), (torch.int32,)
    _check("Q", Q, f32, (b, d), dev)
    _check("qsq", qsq, f32, (b,), dev)
    _check("X", X, f32, (n, d), dev)
    if mode == "l2sq":
        _check("xsq", xsq, f32, (n,), dev)
    _check("probes", probes, (torch.int64, torch.int32), (b, P), dev)
    _check("starts", starts, i32, (n_lists,), dev)
    _check("sizes", sizes, i32, (n_lists,), dev)
    _check("row_ids", row_ids, i32, (n,), dev)
    if row_live is not None:
        _check("row_live", row_live, (torch.uint8,), (n,), dev)
    plan = launch_plan(b, P, n_lists, M, k)
    with torch.cuda.device(dev):
        pairs = pair_build(probes, n_probes, n_lists, sizes)
        part_d, part_i = list_pass(Q, qsq, X, xsq, row_ids, row_live,
                                   starts, sizes, pairs, plan, M=M,
                                   mode=mode, scan=scan)
        out = merge_pass(part_d, part_i, plan, n_probes)
    rerank_lists_kernel.launches += 1
    return out


rerank_lists_kernel.launches = 0

_FNS = {}


def _lib():
    lib = kernels.load("rerank_topk")
    lib.rerank_lists_blocks_per_sm.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.rerank_lists_blocks_per_sm.restype = ctypes.c_int
    lib.rerank_lists_smem_bytes.argtypes = [ctypes.c_int]
    lib.rerank_lists_smem_bytes.restype = ctypes.c_longlong
    return lib


def _lists_fn():
    if "lists" not in _FNS:
        fn = _lib().rerank_lists_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 16 + [i] * 9 + [p]
        fn.restype = i
        _FNS["lists"] = fn
    return _FNS["lists"]


def _merge_fn():
    if "merge" not in _FNS:
        fn = _lib().rerank_merge_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 5 + [p]
        fn.restype = i
        _FNS["merge"] = fn
    return _FNS["merge"]
