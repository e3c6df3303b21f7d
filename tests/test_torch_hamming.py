"""The Hamming slice of the port against the JAX package on the same numpy
inputs: the popcount top-k kernel's wrapper (``kernels/hamming``: on CPU
tensors its plain version, against the reference's Pallas kernel in
interpret mode) and the three algorithms of ``ann/hamming.py``.

Tolerance: none.  Hamming distances are integers held in float32 and every
select orders by (dist, id), so distances and ids are bitwise equal; the
host-built forests and MIH tables are the reference's numpy code, draw for
draw, so they are bitwise equal too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.ann import hamming as jx_ham  # noqa: E402
from repro.kernels.hamming import hamming_topk as jx_hamming_topk  # noqa: E402
from repro.kernels.hamming import (  # noqa: E402
    hamming_topk_ref as jx_hamming_topk_ref)
from repro_torch.ann import hamming  # noqa: E402
from repro_torch.bits import words_to_tensor  # noqa: E402
from repro_torch.kernels.hamming import (hamming_topk,  # noqa: E402
                                         hamming_topk_kernel,
                                         hamming_topk_plain,
                                         hamming_topk_ref)


def _codes(rng, n, w):
    return rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)


def _data(n=1200, nq=30, w=4, seed=0):
    """Random codes and queries that are near-duplicates of corpus rows
    (a few bits flipped), so that near neighbours exist."""
    rng = np.random.default_rng(seed)
    X = _codes(rng, n, w)
    Q = X[rng.integers(0, n, nq)].copy()
    for i in range(nq):
        for p in rng.choice(32 * w, size=rng.integers(1, 8), replace=False):
            Q[i, p // 32] ^= np.uint32(1 << (p % 32))
    return X, Q


def assert_bitwise(want, got):
    wd, wi = (np.asarray(a) for a in want)
    gd, gi = (a.numpy() for a in got)
    assert gi.dtype == np.int32 and gd.dtype == np.float32
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gi, wi)


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("nq,n,w,k", [(8, 256, 4, 5), (17, 300, 8, 10),
                                      (64, 512, 25, 32), (3, 1000, 8, 100)])
def test_hamming_topk_matches_reference_kernel(nq, n, w, k):
    """The reference's Pallas kernel in interpret mode (its own tests'
    route), with bn=128 so both wrappers pad the corpus and mask rows at
    or past n_valid."""
    rng = np.random.default_rng(w)
    Q, X = _codes(rng, nq, w), _codes(rng, n, w)
    want = jx_hamming_topk(Q, X, k=k, bn=128, interpret=True)
    assert_bitwise(want, hamming_topk(Q, X, k=k, bn=128, device="cpu"))
    assert_bitwise(jx_hamming_topk_ref(jnp.asarray(Q), jnp.asarray(X), k=k),
                   hamming_topk_ref(Q, X, k=k))


def test_padded_rows_never_win():
    """Rows at or past n_valid are padding: even at distance 0 (copies of
    the queries) they never enter the list; k > n_valid pads (+inf, -1)."""
    rng = np.random.default_rng(1)
    Q = words_to_tensor(_codes(rng, 5, 3), "cpu")
    X = words_to_tensor(_codes(rng, 40, 3), "cpu")
    Xp = torch.cat([X, Q, Q])
    d, i = hamming_topk_plain(Q, Xp, 40, k=45, bn=16)
    assert (i[:, :40] < 40).all() and (i[:, :40] >= 0).all()
    assert (i[:, 40:] == -1).all() and torch.isinf(d[:, 40:]).all()
    d0, i0 = hamming_topk_plain(Q, X, 40, k=40, bn=7)
    assert torch.equal(d0, d[:, :40]) and torch.equal(i0, i[:, :40])


def test_kernel_wrapper_refuses_what_it_does_not_take():
    X = words_to_tensor(_codes(np.random.default_rng(2), 10, 2), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        hamming_topk_kernel(X, X, 10, k=3)
    with pytest.raises(ValueError, match="k <= 256"):
        hamming_topk_kernel(X, X, 10, k=300)


# ------------------------------------------------------- BruteForceHamming
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_bruteforce_hamming_search(backend, k):
    X, Q = _data(seed=3)
    ref = jx_ham.bruteforce_build(X, backend=backend)
    st = hamming.bruteforce_build(X, backend=backend, device="cpu")
    assert st.static == ref.static
    assert_bitwise(jx_ham.bruteforce_search(ref, jnp.asarray(Q), k=k),
                   hamming.bruteforce_search(st, Q, k=k))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("streaming", [False, True])
def test_bruteforce_hamming_batch(backend, streaming):
    X, Q = _data(seed=4)
    kw = dict(backend=backend, streaming=streaming, corpus_block=300,
              query_block=7)
    want = jx_ham.BruteForceHamming("hamming", **kw)
    got = hamming.BruteForceHamming("hamming", **kw)
    want.fit(X)
    got.fit(X, device="cpu")
    assert got.name == want.name
    want.batch_query(Q, 12)
    got.batch_query(Q, 12)
    np.testing.assert_array_equal(got.get_batch_results(),
                                  np.asarray(want.get_batch_results()))
    assert got.get_additional() == want.get_additional()


# -------------------------------------------------------- BitsamplingAnnoy
def test_bitsampling_build_bitwise():
    X, _ = _data(seed=5)
    ref = jx_ham.bitsampling_build(X, n_trees=4, leaf_size=16, seed=5)
    st = hamming.bitsampling_build(X, n_trees=4, leaf_size=16, seed=5,
                                   device="cpu")
    assert st.static == ref.static and set(st.arrays) == set(ref.arrays)
    for name in ("bits", "children", "leaves", "roots"):
        np.testing.assert_array_equal(st[name].numpy(), np.asarray(ref[name]))
    np.testing.assert_array_equal(st["X"].numpy().view(np.uint32),
                                  np.asarray(ref["X"]))


@pytest.mark.parametrize("kw", [
    {"probe": 1}, {"probe": 5}, {"probe": 3, "trees": 2},
    {"probe": 2, "max_probe": 6, "trees": 3, "max_trees": 4}])
@pytest.mark.parametrize("rerank_kernel", [False, True])
def test_bitsampling_search(kw, rerank_kernel):
    X, Q = _data(seed=6)
    ref = jx_ham.bitsampling_build(X, n_trees=4, leaf_size=16, seed=6)
    st = hamming.bitsampling_build(X, n_trees=4, leaf_size=16, seed=6,
                                   rerank_kernel=rerank_kernel, device="cpu")
    assert_bitwise(jx_ham.bitsampling_search(ref, jnp.asarray(Q), k=10, **kw),
                   hamming.bitsampling_search(st, Q, k=10, **kw))


def test_bitsampling_traced_knobs_equal_static_window():
    X, Q = _data(seed=7)
    st = hamming.bitsampling_build(X, n_trees=5, leaf_size=16, seed=7,
                                   device="cpu")
    for probe, trees in [(1, 1), (3, 2), (6, 5)]:
        want = hamming.bitsampling_search(st, Q, k=10, probe=probe,
                                          trees=trees)
        got = hamming.bitsampling_search(
            st, Q, k=10, probe=torch.tensor(probe), max_probe=6,
            trees=torch.tensor(trees), max_trees=5)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ------------------------------------------------------ MultiIndexHashing
def test_mih_build_bitwise():
    X, _ = _data(w=4, seed=8)
    ref = jx_ham.mih_build(X, n_chunks=8, cap=32)
    st = hamming.mih_build(X, n_chunks=8, cap=32, device="cpu")
    assert st.static == ref.static and set(st.arrays) == set(ref.arrays)
    for name in ("keys", "ids", "bit_weights"):
        np.testing.assert_array_equal(st[name].numpy(), np.asarray(ref[name]))


def test_mih_query_chunks_read_every_bit():
    """Bit 31 of a word is the int32 sign bit: ``(w >> s) & 1`` must read
    it as 1, as the reference's unsigned shift does."""
    X, Q = _data(w=2, seed=9)
    Q[:, :] = np.uint32(0x80000001)
    ref = jx_ham.mih_build(X, n_chunks=4, cap=8)
    st = hamming.mih_build(X, n_chunks=4, cap=8, device="cpu")
    want_keys, want_bits = jx_ham._mih_query_chunks(ref, jnp.asarray(Q))
    keys, bits = hamming._mih_query_chunks(st, words_to_tensor(Q, "cpu"))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(want_keys))
    np.testing.assert_array_equal(bits.reshape(len(Q), -1).numpy(),
                                  np.asarray(want_bits))


@pytest.mark.parametrize("kw", [{"radius": 0}, {"radius": 1}, {"radius": 2},
                                {"radius": 1, "max_radius": 2}])
@pytest.mark.parametrize("rerank_kernel", [False, True])
def test_mih_search(kw, rerank_kernel):
    X, Q = _data(w=4, seed=10)
    ref = jx_ham.mih_build(X, n_chunks=8, cap=32)
    st = hamming.mih_build(X, n_chunks=8, cap=32, rerank_kernel=rerank_kernel,
                           device="cpu")
    assert_bitwise(jx_ham.mih_search(ref, jnp.asarray(Q), k=10, **kw),
                   hamming.mih_search(st, Q, k=10, **kw))


def test_mih_traced_radius_equals_static_window():
    X, Q = _data(w=4, seed=11)
    st = hamming.mih_build(X, n_chunks=8, cap=32, device="cpu")
    for radius in (0, 1, 2):
        want = hamming.mih_search(st, Q, k=10, radius=radius)
        got = hamming.mih_search(st, Q, k=10, radius=torch.tensor(radius),
                                 max_radius=2)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("cls,args,qargs", [
    ("BitsamplingAnnoy", (4, 16, 0, False, None, True), (3,)),
    ("MultiIndexHashing", (8, 32, 0, False, None, True), (1,))])
def test_legacy_classes_match_reference(cls, args, qargs):
    X, Q = _data(seed=12)
    want = getattr(jx_ham, cls)("hamming", *args)
    got = getattr(hamming, cls)("hamming", *args)
    want.fit(X)
    got.fit(X, device="cpu")
    assert got.name == want.name
    want.set_query_arguments(*qargs)
    got.set_query_arguments(*qargs)
    want.batch_query(Q, 10)
    got.batch_query(Q, 10)
    np.testing.assert_array_equal(got.get_batch_results(),
                                  np.asarray(want.get_batch_results()))
    assert got.query(Q[0], 10).tolist() == np.asarray(
        want.query(Q[0], 10)).tolist()
    assert got.get_additional() == want.get_additional()
