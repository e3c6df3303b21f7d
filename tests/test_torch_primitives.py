"""Port parity for the slice's primitives: ``ann/topk.py``,
``ann/distances.py``, ``data/groundtruth.exact_knn`` and ``ann/kmeans.py``,
each held against its JAX counterpart on the same numpy inputs.

Tolerances: float distances rtol=1e-5, atol=1e-4; hamming distances and
ids on integer-valued inputs bitwise; ids on N(0,1) inputs bitwise except
at the reference's near ties (adjacent distances within atol), counted and
expected to be 0; k-means assignments equal for >= 99.9% of the points
(the port sums centers in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.ann import distances as jx_D  # noqa: E402
from repro.ann import kmeans as jx_kmeans  # noqa: E402
from repro.ann import topk as jx_topk  # noqa: E402
from repro.data.groundtruth import exact_knn as jx_exact_knn  # noqa: E402
from repro_torch.ann import distances as D  # noqa: E402
from repro_torch.ann import kmeans as port_kmeans  # noqa: E402
from repro_torch.ann import topk  # noqa: E402
from repro_torch.bits import popcount32, words_to_tensor  # noqa: E402
from repro_torch.data.groundtruth import exact_knn  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _near_tie_mismatches(want_d, want_i, got_i, atol=ATOL):
    want_d, want_i, got_i = (np.asarray(a) for a in (want_d, want_i, got_i))
    bad = want_i != got_i
    near = np.zeros_like(bad)
    gap = np.abs(np.diff(want_d, axis=1)) <= atol
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    return int((bad & ~near).sum()), int((bad & near).sum())


def _tied(rng, shape):
    return rng.integers(0, 6, shape).astype(np.float32)   # many exact ties


# ------------------------------------------------------------------ topk
@pytest.mark.parametrize("k", [1, 7, 30])
def test_topk_smallest_and_with_ids(k):
    rng = np.random.default_rng(k)
    d = _tied(rng, (5, 30))
    ids = rng.permutation(30).astype(np.int32)[None].repeat(5, 0)
    wv, wi = jx_topk.topk_smallest(jnp.asarray(d), k)
    gv, gi = topk.topk_smallest(_t(d), k)
    np.testing.assert_array_equal(np.asarray(wv), gv.numpy())
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())
    wv, wi = jx_topk.topk_with_ids(jnp.asarray(d), jnp.asarray(ids), k)
    gv, gi = topk.topk_with_ids(_t(d), _t(ids), k)
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())


def test_merge_topk():
    rng = np.random.default_rng(1)
    a, b = _tied(rng, (4, 12)), _tied(rng, (4, 9))
    ia = rng.integers(0, 50, (4, 12)).astype(np.int32)
    ib = rng.integers(50, 99, (4, 9)).astype(np.int32)
    wv, wi = jx_topk.merge_topk(a, ia, b, ib, 10)
    gv, gi = topk.merge_topk(_t(a), _t(ia), _t(b), _t(ib), 10)
    np.testing.assert_array_equal(np.asarray(wv), gv.numpy())
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())


def test_dedupe_and_topk_unique():
    rng = np.random.default_rng(2)
    d = _tied(rng, (6, 40))
    ids = rng.integers(-1, 15, (6, 40)).astype(np.int32)
    wd, wi = jx_topk.dedupe_ids(jnp.asarray(d), jnp.asarray(ids))
    gd, gi = topk.dedupe_ids(_t(d), _t(ids))
    np.testing.assert_array_equal(np.asarray(wd), gd.numpy())
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())
    wv, wi = jx_topk.topk_unique(jnp.asarray(d), jnp.asarray(ids), 12)
    gv, gi = topk.topk_unique(_t(d), _t(ids), 12)
    np.testing.assert_array_equal(np.asarray(wv), gv.numpy())
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())


@pytest.mark.parametrize("unique", [False, True])
def test_chunked_topk(unique):
    rng = np.random.default_rng(3)
    d = _tied(rng, (3, 100))
    ids = rng.integers(0, 40, (3, 100)).astype(np.int32)

    def jx_chunk(s, size):
        return jnp.asarray(d[:, s:s + size]), jnp.asarray(ids[:, s:s + size])

    def chunk(s, size):
        return _t(d[:, s:s + size]), _t(ids[:, s:s + size])

    wv, wi = jx_topk.chunked_topk(100, 15, 8, jx_chunk, unique=unique)
    gv, gi = topk.chunked_topk(100, 15, 8, chunk, unique=unique)
    np.testing.assert_array_equal(np.asarray(wv), gv.numpy())
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())


def test_np_topk():
    rng = np.random.default_rng(4)
    d = rng.standard_normal((5, 50)).astype(np.float32)
    for w, g in zip(jx_topk.np_topk(d, 9), topk.np_topk(d, 9)):
        np.testing.assert_array_equal(w, g)


# ------------------------------------------------------------- distances
def test_float_distance_matrices():
    rng = np.random.default_rng(5)
    Q = rng.standard_normal((20, 32)).astype(np.float32)
    X = rng.standard_normal((300, 32)).astype(np.float32)
    for metric in ("euclidean", "angular"):
        want = np.asarray(jx_D.distance_matrix(jnp.asarray(Q),
                                               jnp.asarray(X), metric))
        got = D.distance_matrix(_t(Q), _t(X), metric).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want = np.asarray(jx_D.sq_l2_matrix(jnp.asarray(Q), jnp.asarray(X)))
    np.testing.assert_allclose(D.sq_l2_matrix(_t(Q), _t(X)).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_hamming_matrix_bitwise():
    rng = np.random.default_rng(6)
    Q = rng.integers(0, 2**32, (9, 5), dtype=np.uint64).astype(np.uint32)
    X = rng.integers(0, 2**32, (70, 5), dtype=np.uint64).astype(np.uint32)
    X[0] = 0xFFFFFFFF
    want = np.asarray(jx_D.hamming_matrix(jnp.asarray(Q), jnp.asarray(X)))
    got = D.hamming_matrix(words_to_tensor(Q, "cpu"),
                           words_to_tensor(X, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    bits = np.unpackbits(X.view(np.uint8), axis=1).sum(axis=1)
    np.testing.assert_array_equal(
        popcount32(words_to_tensor(X, "cpu")).sum(dim=1).numpy(), bits)


@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
def test_pairwise_rows(metric):
    rng = np.random.default_rng(7)
    if metric == "hamming":
        test = rng.integers(0, 2**32, (12, 4), dtype=np.uint64)
        train = rng.integers(0, 2**32, (200, 4), dtype=np.uint64)
        test, train = test.astype(np.uint32), train.astype(np.uint32)
    else:
        test = rng.standard_normal((12, 24)).astype(np.float32)
        train = rng.standard_normal((200, 24)).astype(np.float32)
    nbrs = rng.integers(-1, 200, (12, 6))
    want = jx_D.pairwise_rows(test, train, nbrs, metric)
    got = D.pairwise_rows(test, train, nbrs, metric, device="cpu")
    if metric == "hamming":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------- ground truth
@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
def test_exact_knn_matches_reference(metric):
    rng = np.random.default_rng(8)
    if metric == "hamming":
        train = rng.integers(0, 2**32, (1500, 4), dtype=np.uint64)
        test = rng.integers(0, 2**32, (40, 4), dtype=np.uint64)
        train, test = train.astype(np.uint32), test.astype(np.uint32)
    else:
        train = rng.standard_normal((1500, 32)).astype(np.float32)
        test = rng.standard_normal((40, 32)).astype(np.float32)
    wi, wd = jx_exact_knn(train, test, 25, metric, query_block=16,
                          corpus_block=400)
    gi, gd = exact_knn(train, test, 25, metric, query_block=16,
                       corpus_block=400, device="cpu")
    assert gi.dtype == np.int64 and gd.dtype == np.float32
    if metric == "hamming":       # integer distances: ties, bitwise ids
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gi, wi)
    else:
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
        assert _near_tie_mismatches(wd, wi, gi) == (0, 0)


# ---------------------------------------------------------------- kmeans
def test_kmeanspp_init_identical():
    X = np.random.default_rng(9).standard_normal((3000, 16)).astype(
        np.float32)
    want = jx_kmeans.kmeanspp_init(X, 20, np.random.default_rng(3),
                                   sample_cap=1000)
    got = port_kmeans.kmeanspp_init(X, 20, np.random.default_rng(3),
                                    sample_cap=1000)
    np.testing.assert_array_equal(got, want)


def test_kmeans_assignment_agrees():
    rng = np.random.default_rng(10)
    centers = rng.standard_normal((12, 24)).astype(np.float32) * 4
    X = (centers[rng.integers(0, 12, 2000)]
         + rng.standard_normal((2000, 24)).astype(np.float32))
    wc, wa = jx_kmeans.kmeans(X, 16, n_iters=8, seed=1, block=700)
    gc, ga = port_kmeans.kmeans(X, 16, n_iters=8, seed=1, block=700,
                                device="cpu")
    assert np.mean(np.asarray(wa) == ga) >= 0.999
    np.testing.assert_allclose(gc, np.asarray(wc), rtol=1e-4, atol=1e-4)
