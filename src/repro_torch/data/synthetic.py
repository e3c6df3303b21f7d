"""Synthetic dataset builders (paper §4, Table 3 analogues), as
``repro.data.synthetic``.

The builders are the reference's, draw for draw, so that in one process
both packages build bitwise-identical datasets.  That includes ``_seed``,
which seeds by ``hash(name)``: Python randomizes string hashes per process
(PYTHONHASHSEED), so a dataset differs from one process to the next unless
the cache already holds it.  Ground truth is computed on ``device``.

All offline (no network), deterministic per name.  Sizes are parameterised in
the dataset name so that CPU tests use small instances while benchmarks can
scale up:

    random-euclidean-<n>          the paper's adversarial Rand-Euclidean
    blobs-euclidean-<n>           clustered Gaussian mixture (SIFT-like)
    random-angular-<n>            unit-sphere vectors, cosine (GLOVE-like)
    blobs-angular-<n>
    random-hamming-<n>            packed binary (SIFT-Hamming/Word2Bits-like)
    mnist-like-<n>                low-rank + noise image-descriptor analogue

Each builder computes exact ground truth for k=100 (or n if smaller).
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.datasets import Dataset, GT_K, register_dataset
from repro_torch.data.groundtruth import exact_knn

_NQ_FRACTION = 0.01  # paper: 10k queries for ~1M points


def _nq(n: int) -> int:
    return max(10, min(10_000, int(n * _NQ_FRACTION) or 10))


def _seed(name: str) -> np.random.Generator:
    return np.random.default_rng(abs(hash(name)) % (2**32))


def _finish(name, train, test, metric, point_type="float", k=GT_K,
            device=None) -> Dataset:
    k = min(k, train.shape[0])
    neighbors, distances = exact_knn(train, test, k, metric, device=device)
    return Dataset(name=name, train=train, test=test, neighbors=neighbors,
                   distances=distances, metric=metric, point_type=point_type)


@register_dataset(r"random-euclidean-(?P<n>\d+)(?:-d(?P<d>\d+))?")
def random_euclidean(name: str, n: int, d: int | None = None, device=None) -> Dataset:
    """The paper's Rand-Euclidean construction (§4 Datasets).

    n - k*n' points (v, 0) with v a random unit vector of dim d/2; n' query
    points get their second half replaced by a random vector of length
    1/sqrt(2); for each query, k planted points at distances 0.1..0.5.
    Queries are locally easy but globally structureless.
    """
    d = d or 64
    assert d % 2 == 0
    k = 10
    nq = _nq(n)
    rng = _seed(name)

    def unit(rows, dim):
        v = rng.standard_normal((rows, dim)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    n_base = n - k * nq
    base = np.concatenate(
        [unit(n_base, d // 2), np.zeros((n_base, d // 2), np.float32)], axis=1)

    # pick queries from base points, replace second half
    q_ids = rng.choice(n_base, size=nq, replace=False)
    queries = base[q_ids].copy()
    queries[:, d // 2:] = unit(nq, d // 2) / np.sqrt(2.0)

    # plant k neighbors per query at distances 0.1..0.5
    planted = []
    dists = np.linspace(0.1, 0.5, k).astype(np.float32)
    for i in range(nq):
        dirs = unit(k, d)
        planted.append(queries[i][None, :] + dirs * dists[:, None])
    train = np.concatenate([base] + planted, axis=0).astype(np.float32)
    return _finish(name, train, queries, "euclidean", device=device)


@register_dataset(r"blobs-(?P<metric>euclidean|angular)-(?P<n>\d+)(?:-d(?P<d>\d+))?")
def blobs(name: str, metric: str, n: int, d: int | None = None, device=None) -> Dataset:
    """Gaussian-mixture clusters: the 'real-data-like' regime (SIFT/GLOVE)."""
    d = d or 64
    n_centers = max(8, int(np.sqrt(n) / 4))
    rng = _seed(name)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 3.0
    assign = rng.integers(0, n_centers, size=n)
    pts = centers[assign] + rng.standard_normal((n, d)).astype(np.float32)
    nq = _nq(n)
    qa = rng.integers(0, n_centers, size=nq)
    queries = centers[qa] + rng.standard_normal((nq, d)).astype(np.float32)
    if metric == "angular":
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return _finish(name, pts.astype(np.float32), queries.astype(np.float32),
                   metric, device=device)


@register_dataset(r"random-angular-(?P<n>\d+)(?:-d(?P<d>\d+))?")
def random_angular(name: str, n: int, d: int | None = None, device=None) -> Dataset:
    d = d or 64
    rng = _seed(name)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    nq = _nq(n)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return _finish(name, pts, queries, "angular", device=device)


@register_dataset(r"random-hamming-(?P<n>\d+)(?:-b(?P<bits>\d+))?")
def random_hamming(name: str, n: int, bits: int | None = None, device=None) -> Dataset:
    """Binary data packed into uint32 words (paper Q4: SIFT-Hamming,
    Word2Bits).  Structure: random codes + planted near-duplicates so that
    near neighbors exist."""
    bits = bits or 256
    assert bits % 32 == 0
    words = bits // 32
    rng = _seed(name)
    codes = rng.integers(0, 2**32, size=(n, words), dtype=np.uint64).astype(
        np.uint32)
    nq = _nq(n)
    # queries: near-duplicates of random corpus points (flip a few bits)
    src = rng.choice(n, size=nq, replace=False)
    queries = codes[src].copy()
    for i in range(nq):
        nflips = rng.integers(1, max(2, bits // 16))
        positions = rng.choice(bits, size=nflips, replace=False)
        for p in positions:
            queries[i, p // 32] ^= np.uint32(1 << (p % 32))
    return _finish(name, codes, queries, "hamming", point_type="bit", device=device)


@register_dataset(r"mnist-like-(?P<n>\d+)")
def mnist_like(name: str, n: int, device=None) -> Dataset:
    """Low-rank-plus-noise image-descriptor analogue (MNIST-ish spectrum)."""
    d, rank = 128, 16
    rng = _seed(name)
    basis = rng.standard_normal((rank, d)).astype(np.float32)
    coeff = rng.standard_normal((n, rank)).astype(np.float32)
    pts = coeff @ basis + 0.05 * rng.standard_normal((n, d)).astype(np.float32)
    nq = _nq(n)
    qc = rng.standard_normal((nq, rank)).astype(np.float32)
    queries = qc @ basis + 0.05 * rng.standard_normal((nq, d)).astype(np.float32)
    return _finish(name, pts.astype(np.float32), queries.astype(np.float32),
                   "euclidean", device=device)
