"""BruteForce and IVF of the port against the JAX package, through the
functional API: every metric and backend, the ``live=`` / ``id_map=``
masks, the streaming batch path, and IVF's ``scan`` / ``max_scan`` and
``n_probes`` / ``max_probes`` windows.

Tolerances: float distances rtol=1e-5, atol=1e-4; hamming distances and
ids on integer-valued inputs bitwise; ids on N(0,1) inputs bitwise except
at the reference's near ties (adjacent distances within atol), counted and
expected to be 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.ann import bruteforce as jx_bf  # noqa: E402
from repro.ann import ivf as jx_ivf  # noqa: E402
from repro_torch.ann import bruteforce as bf  # noqa: E402
from repro_torch.ann import ivf  # noqa: E402
from repro_torch.convert import state_from_reference  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4


def assert_same(want, got, metric):
    wd, wi = (np.asarray(a) for a in want)
    gd, gi = (a.numpy() for a in got)
    assert gi.shape == wi.shape and gi.dtype == np.int32
    if metric == "hamming":
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gi, wi)
        return
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
    bad = gi != wi
    near = np.zeros_like(bad)
    gap = np.abs(np.diff(wd, axis=1)) <= ATOL
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert int((bad & ~near).sum()) == 0, "id mismatches outside near ties"
    assert int((bad & near).sum()) == 0, "id mismatches at near ties"


def _data(metric, n=800, nq=24, d=20, seed=0):
    rng = np.random.default_rng(seed)
    if metric == "hamming":
        X = rng.integers(0, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)
        Q = X[rng.integers(0, n, nq)] ^ np.uint32(1 << 5)
        return X, Q
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    return X, Q


@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_bruteforce_search(metric, backend):
    X, Q = _data(metric)
    ref = jx_bf.build(X, metric=metric, backend=backend)
    st = bf.build(X, metric=metric, backend=backend, device="cpu")
    assert st.static == ref.static
    assert_same(jx_bf.search(ref, jnp.asarray(Q), k=10),
                bf.search(st, Q, k=10), metric)


@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
def test_bruteforce_live_and_id_map(metric):
    X, Q = _data(metric, seed=1)
    rng = np.random.default_rng(1)
    live = rng.random(X.shape[0]) < 0.7
    id_map = rng.permutation(X.shape[0]).astype(np.int32) + 5000
    ref = jx_bf.build(X, metric=metric)
    st = bf.build(X, metric=metric, device="cpu")
    want = jx_bf.search(ref, jnp.asarray(Q), k=12, live=jnp.asarray(live),
                        id_map=jnp.asarray(id_map))
    got = bf.search(st, Q, k=12, live=live, id_map=id_map)
    assert_same(want, got, metric)
    assert not np.isin(got[1].numpy(), id_map[~live]).any()


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_bruteforce_streaming_batch(metric):
    X, Q = _data(metric, seed=2)
    want = jx_bf.BruteForce(metric, "pallas", streaming=True, query_block=7)
    want.fit(X)
    want.batch_query(Q, 9)
    got = bf.BruteForce(metric, "pallas", streaming=True, query_block=7)
    got.fit(X, device="cpu")
    got.batch_query(Q, 9)
    np.testing.assert_array_equal(got.get_batch_results(),
                                  np.asarray(want.get_batch_results()))
    assert got.get_additional() == want.get_additional()


def test_bruteforce_rejects_what_the_reference_rejects():
    X, _ = _data("euclidean")
    with pytest.raises(ValueError):
        bf.build(X, backend="jnp", streaming=True, device="cpu")
    with pytest.raises(ValueError, match="streaming"):
        bf.build(X, backend="pallas", streaming=True, quantize="pq",
                 device="cpu")
    st = bf.build(X, backend="pallas", device="cpu")
    with pytest.raises(ValueError):
        bf.search(st, X[:2], k=3, live=np.ones(len(X), bool))


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_ivf_windows_and_masks(metric):
    """scan / max_scan and n_probes / max_probes on a reference-built index,
    static and capped, plus live= / id_map=."""
    X, Q = _data(metric, n=1200, seed=3)
    ref = jx_ivf.build(X, metric=metric, n_clusters=16)
    st = state_from_reference(
        "IVF", metric, {k: np.asarray(v) for k, v in ref.arrays.items()},
        ref.static, device="cpu")
    rng = np.random.default_rng(3)
    live = rng.random(X.shape[0]) < 0.8
    id_map = rng.permutation(X.shape[0]).astype(np.int32)
    for kw in ({"n_probes": 3, "scan": 20},
               {"n_probes": 2, "max_probes": 6, "scan": 15, "max_scan": 40},
               {"n_probes": 4}):
        assert_same(jx_ivf.search(ref, jnp.asarray(Q), k=10, **kw),
                    ivf.search(st, Q, k=10, **kw), metric)
    assert_same(
        jx_ivf.search(ref, jnp.asarray(Q), k=10, n_probes=4,
                      live=jnp.asarray(live), id_map=jnp.asarray(id_map)),
        ivf.search(st, Q, k=10, n_probes=4, live=live, id_map=id_map),
        metric)


def test_ivf_build_layout_matches_reference():
    X, _ = _data("euclidean", n=1500, seed=4)
    ref = jx_ivf.build(X, metric="euclidean", n_clusters=12)
    st = ivf.build(X, metric="euclidean", n_clusters=12, device="cpu")
    assert set(st.arrays) == set(ref.arrays)
    assert st.static == ref.static
    agree = np.mean(st["ids"].numpy() == np.asarray(ref["ids"]))
    assert agree >= 0.999
    np.testing.assert_allclose(st["centers"].numpy(),
                               np.asarray(ref["centers"]), rtol=1e-4,
                               atol=1e-4)
