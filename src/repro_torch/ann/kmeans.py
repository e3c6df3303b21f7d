"""Mini k-means (Lloyd's iterations, k-means++ seeding): the coarse
quantizer behind IVF, as ``repro.ann.kmeans``.

The seeding is the reference's numpy code, draw for draw, so both packages
start from the same centers.  The Lloyd steps run on ``device``: a blocked
assignment (``torch.argmin``, first index on ties, like ``jnp.argmin``) and
an update that sums each cluster's points in index order within each block
of the assignment's ``block`` points (``torch.segment_reduce`` over the
block sorted stably by cluster), then the blocks' sums in block order.
That order is fixed, so a center is the same bits on every run and on
every device (below ``block`` points, the sequential sum's);
``index_add_`` on CUDA sums with atomics, in an order that changes from
run to run, so two builds of one corpus could differ.  A block's sorted
copy is the only copy of the points the update makes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ann import distances as D


def kmeanspp_init(X: np.ndarray, n_clusters: int, rng: np.random.Generator,
                  sample_cap: int = 16384) -> np.ndarray:
    """k-means++ seeding on a subsample (standard practice for IVF)."""
    n = X.shape[0]
    if n > sample_cap:
        X = X[rng.choice(n, sample_cap, replace=False)]
        n = sample_cap
    centers = np.empty((n_clusters, X.shape[1]), np.float32)
    centers[0] = X[rng.integers(n)]
    d2 = np.sum((X - centers[0]) ** 2, axis=1)
    for c in range(1, n_clusters):
        probs = d2 / max(d2.sum(), 1e-12)
        centers[c] = X[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((X - centers[c]) ** 2, axis=1))
    return centers


def _assign(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return torch.argmin(D.sq_l2_matrix(X, centers), dim=1)


def _update(X: torch.Tensor, assign: torch.Tensor, n_clusters: int,
            block: int):
    sums = None
    for s in range(0, X.shape[0], block):
        a = assign[s:s + block]
        order = torch.sort(a, stable=True).indices
        part = torch.segment_reduce(
            X[s:s + block][order], "sum",
            lengths=torch.bincount(a, minlength=n_clusters), axis=0,
            unsafe=True)
        sums = part if sums is None else sums + part
    counts = torch.bincount(assign, minlength=n_clusters).to(torch.float32)
    return sums / torch.clamp_min(counts, 1.0)[:, None], counts


def kmeans(
    X: np.ndarray,
    n_clusters: int,
    n_iters: int = 10,
    seed: int = 0,
    block: int = 262144,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (centers [C, d], assignment [n]) as numpy arrays."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    Xf = np.asarray(X, np.float32)
    centers = torch.as_tensor(kmeanspp_init(Xf, n_clusters, rng)).to(dev)
    Xt = torch.as_tensor(Xf).to(dev)

    def assign_all():
        return torch.cat([_assign(Xt[s:s + block], centers)
                          for s in range(0, Xf.shape[0], block)])

    for _ in range(n_iters):
        assign = assign_all()
        new_centers, counts = _update(Xt, assign, n_clusters, block)
        # keep empty clusters where they were
        centers = torch.where(counts[:, None] > 0, new_centers, centers)
    assign = assign_all()
    return centers.cpu().numpy(), assign.cpu().numpy()
