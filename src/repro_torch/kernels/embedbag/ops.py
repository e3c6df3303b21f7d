"""Public wrapper for the embedding-bag kernel
(``repro.kernels.embedbag.ops``).

``embedding_bag(table, indices, bags, weights, n_bags=...)`` sorts the
lookups by bag id with a stable sort unless ``assume_sorted`` (the
kernel's layout contract), cuts them into runs of equal bag ids, and keeps
the last run of each bag: the Pallas kernel re-initialises a bag's row at
each new run, so with ``assume_sorted=True`` and unsorted bags the last
run wins.  Bags without a run are zero (the reference's final mask).  CUDA
tensors go to the kernel (``embedding_bag_kernel``), CPU tensors to its
plain version.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels.embedbag.embedbag import (embedding_bag_kernel,
                                                   embedding_bag_plain)


def bag_runs(bags: torch.Tensor, *, n_bags: int):
    """(start, end, bag) int32 of the runs of equal ids in ``bags`` that
    write: the last run of each bag id.  Raises if a bag id lies outside
    [0, n_bags): the kernel writes each run's row unchecked."""
    N = bags.shape[0]
    dev = bags.device
    if N == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return empty, empty, empty
    lo, hi = _bounds(bags)
    if lo < 0 or hi >= n_bags:
        raise ValueError(f"embedding_bag: bag ids span [{lo}, {hi}], outside "
                         f"[0, {n_bags})")
    new = torch.ones(N, dtype=torch.bool, device=dev)
    new[1:] = bags[1:] != bags[:-1]
    start = torch.nonzero(new).squeeze(1)
    end = torch.cat([start[1:], torch.tensor([N], device=dev)])
    bag = bags[start].long()
    run = torch.arange(start.numel(), device=dev)
    last = torch.full((hi + 1,), -1, dtype=torch.long,
                      device=dev).scatter_reduce(0, bag, run, reduce="amax")
    keep = last[bag] == run
    return (start[keep].to(torch.int32), end[keep].to(torch.int32),
            bag[keep].to(torch.int32))


def _bounds(t: torch.Tensor):
    """(min, max) of a non-empty integer tensor, with one host sync."""
    lo, hi = torch.aminmax(t)
    return torch.stack([lo, hi]).tolist()


def embedding_bag(table, indices, bags, weights=None, *, n_bags: int,
                  assume_sorted: bool = False, device=None):
    """[n_bags, D] weighted sums of table rows, in the table's type.

    A tensor ``table`` fixes the device; an array goes to ``device``
    (``cuda`` unless the caller asks for ``cpu``)."""
    dev = table.device if torch.is_tensor(table) else resolve_device(device)
    table = torch.as_tensor(table).to(dev).contiguous()
    indices = torch.as_tensor(indices).to(device=dev, dtype=torch.int32)
    bags = torch.as_tensor(bags).to(device=dev, dtype=torch.int32)
    if weights is None:
        weights = torch.ones(indices.shape, dtype=torch.float32, device=dev)
    weights = torch.as_tensor(weights).to(device=dev, dtype=torch.float32)
    if indices.numel():
        lo, hi = _bounds(indices)
        if lo < 0 or hi >= table.shape[0]:
            raise ValueError(f"embedding_bag: indices span [{lo}, {hi}], "
                             f"outside the table's [0, {table.shape[0]})")
    if not assume_sorted:
        order = torch.sort(bags, stable=True).indices
        indices, bags, weights = indices[order], bags[order], weights[order]
    runs = bag_runs(bags, n_bags=n_bags)
    fn = embedding_bag_kernel if table.is_cuda else embedding_bag_plain
    return fn(indices.contiguous(), weights.contiguous(), table, runs,
              n_bags=n_bags)
