"""Public wrappers for the ADC (asymmetric-distance) code scan
(``repro.kernels.adc_scan.ops``).

``adc_scan``        full-corpus compressed scan: per-query LUTs
                    (:func:`repro_torch.quant.build_luts`) against the
                    packed ``[n, m]`` code table.  Two paths with the same
                    select:

                    * **torch gather-fold** (default): each code block
                      indexes the flattened ``[b, m*K]`` tables, the
                      subspace entries are summed, blocks fold through
                      ``chunked_topk(unique=True)``; peak memory
                      O(b * (block * m + C));
                    * **kernel** (``use_kernel=True``, the ``adc_kernel``
                      build flag): the hand-written Hopper kernel
                      ``csrc/adc_scan.cu`` on CUDA tensors, its plain
                      version on CPU tensors.  It keeps at most
                      ``MAX_C`` candidates; above that (``n_cand=None``
                      scans with C = n) the kernel's sums-out entry writes
                      the [chunk, n] sums and a stable sort selects by
                      (dist, row) (``sums_route``).

``adc_window_topk`` the candidate-window variant for list-organised indexes
                    (IVF): gathers each candidate's ``m``-byte code and
                    folds the same way, with the probe/scan validity masks
                    flowing in as in ``rerank_topk``.  The reference runs
                    it in XLA only, so it stays torch here.

Both return rows sorted by (dist, id) ascending with (+inf, -1) padding,
the ``topk_unique`` contract, so a traced ``n_cand`` mask over the
top-``max_cand`` prefix equals the static ``n_cand`` window.  Every path
sums the subspaces in index order, so fold and kernel agree bit for bit;
against the reference (XLA's reduction order) distances agree to a few
ulps and ids outside near ties.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.adc_scan.adc_scan import (MAX_C, adc_scan_kernel,
                                                   adc_scan_plain,
                                                   adc_sums_kernel,
                                                   adc_sums_plain, lookup,
                                                   sum_in_order)

_FOLD_BUDGET = 32 << 20     # torch fold: per-block gathered LUT working set


def pick_adc_block(b: int, n: int, m: int, k: int, *,
                   budget: int = _FOLD_BUDGET) -> int:
    """Largest power-of-two code-block (256..8192) whose per-fold working
    set -- the [b, block, m] gathered LUT entries plus [b, block + 3k]
    merge state -- fits ``budget``; small corpora collapse to one block."""
    block = 8192

    def working_set(blk: int) -> int:
        return 4 * max(1, b) * (blk * (m + 2) + 3 * k)

    while block > 256 and block >= 2 * max(1, n):
        block //= 2
    while block > 256 and working_set(block) > budget:
        block //= 2
    return block


def adc_scan(codes, luts, *, k: int, block: Optional[int] = None,
             use_kernel: bool = False):
    """(adc_dists [b, kk], rows [b, kk]) of the kk = min(k, n) best rows.

    ``codes [n, m]`` uint8 code table; ``luts [b, m, K]`` float32 per-query
    tables.  ``block`` overrides the fold's code block; ``use_kernel``
    routes through the Hopper kernel (the ``adc_kernel`` build flag).
    """
    from repro_torch.ann.topk import chunked_topk   # deferred: import cycle

    n, m = codes.shape
    b = luts.shape[0]
    kk = min(int(k), n)
    if use_kernel and n > 0 and b > 0:
        if kk > MAX_C:
            return sums_route(codes.contiguous(), luts.contiguous(), k=kk)
        fn = adc_scan_kernel if codes.is_cuda else adc_scan_plain
        return fn(codes.contiguous(), luts.contiguous(), k=kk)
    blk = block if block else pick_adc_block(b, n, m, kk)

    def chunk(s, size):
        d = lookup(codes[s:s + size], luts)
        rows = torch.arange(s, s + size, dtype=torch.int32,
                            device=luts.device).expand(b, -1)
        return d, rows

    return chunked_topk(n, kk, blk, chunk, unique=True)


def sums_route(codes, luts, *, k: int):
    """The scan kernel's contract for any C = ``k``: the ADC sums out per
    chunk of queries, then the k smallest (dist, row) by a stable sort.  A
    full scan holds every row once, so this is the unique-by-id select."""
    dist = adc_sums_kernel if codes.is_cuda else adc_sums_plain
    rows = torch.arange(codes.shape[0], dtype=torch.int32,
                        device=luts.device)
    return kernels.by_query_chunks(luts.shape[0], lambda s, e: dist(
        codes, luts[s:e]), rows, k)


def adc_window_topk(codes, luts, cand, *, k: int, valid=None,
                    block: Optional[int] = None):
    """ADC top-k over a [b, C] candidate window (IVF's probed lists).

    ``cand`` holds row indices into ``codes`` (-1 = masked); ``valid`` is
    the optional extra [b, C] mask.  Returns (adc_dists [b, kk], rows
    [b, kk]) with rows from ``cand`` (-1 where masked or padded),
    kk = min(k, C)."""
    from repro_torch.ann.topk import chunked_topk   # deferred: import cycle

    dev = luts.device
    cand = torch.as_tensor(cand, device=dev).to(torch.int32)
    b, C = cand.shape
    kk = min(int(k), C)
    if C == 0:
        return (torch.full((b, 0), float("inf"), device=dev),
                torch.full((b, 0), -1, dtype=torch.int32, device=dev))
    bad = cand < 0
    if valid is not None:
        bad = bad | ~torch.as_tensor(valid, device=dev).to(torch.bool)
    _, m, K = luts.shape
    flat = luts.reshape(b, m * K)
    offs = torch.arange(m, device=dev) * K
    blk = block if block else pick_adc_block(b, C, m, kk)
    inf = torch.tensor(float("inf"), device=dev)

    def chunk(s, size):
        cnd = cand[:, s:s + size]
        bd = bad[:, s:s + size]
        cd = codes[torch.clamp_min(cnd, 0).long()]              # [b, c, m]
        idx = (cd.long() + offs[None, None, :]).reshape(b, -1)
        d = sum_in_order(torch.take_along_dim(flat, idx, dim=1)
                         .reshape(b, size, m))
        d = d + torch.where(bd, inf, 0.0)
        return d, torch.where(bd, torch.full_like(cnd, -1), cnd)

    return chunked_topk(C, kk, blk, chunk, unique=True)
