"""Top-k utilities shared by all algorithms (``repro.ann.topk``).

All helpers operate on *distances* (smaller is better) and keep (dist, id)
pairs together.  Ties follow ``jax.lax.top_k``: the lower position wins.
``torch.topk`` and an unstable ``torch.sort`` do not promise that order, so
every select here is a stable sort.
"""

from __future__ import annotations

import numpy as np
import torch


def topk_smallest(d: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries along the last axis,
    ascending, equal values in index order."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_with_ids(d: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k smallest of d (last axis), returning the matching ids."""
    vals, pos = topk_smallest(d, k)
    return vals, torch.take_along_dim(ids, pos, dim=-1)


def merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Merge two (dist, id) candidate sets into the k best."""
    d = torch.cat([d_a, d_b], dim=-1)
    i = torch.cat([i_a, i_b], dim=-1)
    return topk_with_ids(d, i, k)


def dedupe_ids(d: torch.Tensor, ids: torch.Tensor):
    """Mask duplicate ids (keep the first by distance) by setting their
    distance to +inf and id to -1.  Works along the last axis.

    Sorts by (id, dist) -- a stable sort by distance, then a stable sort by
    id, which is ``jnp.lexsort((d, ids))`` -- and marks an entry a duplicate
    when its id equals its predecessor's.  Restores no particular order.
    """
    o1 = torch.sort(d, dim=-1, stable=True).indices
    o2 = torch.sort(torch.take_along_dim(ids, o1, dim=-1), dim=-1,
                    stable=True).indices
    order = torch.take_along_dim(o1, o2, dim=-1)
    ds = torch.take_along_dim(d, order, dim=-1)
    is_ = torch.take_along_dim(ids, order, dim=-1)
    prev = torch.cat([torch.full(is_.shape[:-1] + (1,), -2, dtype=is_.dtype,
                                 device=is_.device), is_[..., :-1]], dim=-1)
    dup = (is_ == prev) | (is_ < 0)
    ds = torch.where(dup, torch.full_like(ds, float("inf")), ds)
    is_ = torch.where(dup, torch.full_like(is_, -1), is_)
    return ds, is_


def topk_unique(d: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k smallest with duplicate ids removed (first win)."""
    ds, is_ = dedupe_ids(d, ids)
    return topk_with_ids(ds, is_, k)


def chunked_topk(n_items: int, k: int, block: int, chunk_fn,
                 unique: bool = False):
    """Streaming top-k over a candidate axis of length ``n_items``.

    ``chunk_fn(start, size) -> (dists [b, size], ids [b, size])`` produces
    one chunk of candidates; chunks fold into a running (dist, id) state, so
    peak memory is O(b * (block + k)).  With ``unique=True`` every fold
    dedupes ids, which makes the result identical to one ``topk_unique``
    over the whole axis.
    """
    select = topk_unique if unique else topk_with_ids
    k = min(k, n_items)
    vals = ids = None
    for s in range(0, n_items, block):
        d, i = chunk_fn(s, min(block, n_items - s))
        if vals is not None:
            d = torch.cat([vals, d], dim=-1)
            i = torch.cat([ids, i], dim=-1)
        kk = min(k, d.shape[-1])
        vals, ids = select(d, i, kk)
        if kk < k:          # early chunks smaller than k: pad the state
            vals = torch.nn.functional.pad(vals, (0, k - kk),
                                           value=float("inf"))
            ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return vals, ids


def np_topk(d: np.ndarray, k: int):
    k = min(k, d.shape[-1])
    part = np.argpartition(d, k - 1, axis=-1)[..., :k]
    pd = np.take_along_axis(d, part, axis=-1)
    order = np.argsort(pd, axis=-1, kind="stable")
    return (np.take_along_axis(pd, order, axis=-1),
            np.take_along_axis(part, order, axis=-1))
