"""Port parity for the two kernels of the first slice: the streaming
distance + top-k (``repro_torch.kernels.distance_topk``) and the fused
candidate rerank (``repro_torch.kernels.rerank_topk``), held against the
JAX package on the same numpy inputs.  The JAX kernels run in Pallas
interpret mode on the CPU; the port runs each kernel's plain PyTorch
version, which is what its wrapper does with CPU tensors.

Tolerances:
  * float distances: rtol=1e-5, atol=1e-4 (sums taken in another order);
  * hamming distances: bitwise (integer popcounts);
  * ids on integer-valued inputs: bitwise -- every fp32 distance is exact,
    so only the (dist, id) tie rule decides;
  * ids on N(0,1) inputs: bitwise except where the reference's
    neighbouring distances lie within atol; those places are counted and
    expected to be 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.distance_topk import ops as jx_stream  # noqa: E402
from repro.kernels.distance_topk import ref as jx_stream_ref  # noqa: E402
from repro.kernels.distance_topk.distance_topk import (  # noqa: E402
    merge_topk_rounds as jx_merge_rounds)
from repro.kernels.rerank_topk import ops as jx_rerank  # noqa: E402
from repro.kernels.rerank_topk import ref as jx_rerank_ref  # noqa: E402
from repro.kernels.rerank_topk.rerank_topk import (  # noqa: E402
    merge_topk_unique_rounds as jx_merge_unique)
from repro_torch.kernels.distance_topk import (  # noqa: E402
    merge_topk_rounds, stream_topk, stream_topk_batched, stream_topk_kernel,
    stream_topk_ref, stream_topk_ref_scan)
from repro_torch.kernels.rerank_topk import (  # noqa: E402
    merge_topk_unique_rounds, rerank_topk, rerank_topk_kernel,
    rerank_topk_ref)

RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _data(kind, rng, shape):
    if kind == "int":
        return rng.integers(-3, 4, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def assert_same_ids(want_d, want_i, got_i, atol=ATOL):
    """ids bitwise, with mismatches at the reference's near ties (adjacent
    distances within ``atol``) counted apart; both counts must be 0."""
    want_d, want_i, got_i = (np.asarray(a) for a in (want_d, want_i, got_i))
    assert want_i.shape == got_i.shape
    bad = want_i != got_i
    near = np.zeros_like(bad)
    if want_d.shape[1] > 1:
        gap = np.abs(np.diff(want_d, axis=1)) <= atol
        near[:, 1:] |= gap
        near[:, :-1] |= gap
    assert int((bad & ~near).sum()) == 0, "id mismatches outside near ties"
    assert int((bad & near).sum()) == 0, "id mismatches at near ties"


def assert_dists(want, got, metric="euclidean"):
    want, got = np.asarray(want), np.asarray(got)
    if metric == "hamming":
        np.testing.assert_array_equal(want, got)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------- kernel 1: stream
@pytest.mark.parametrize("metric", ["euclidean", "ip", "angular"])
@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_stream_topk_matches_reference(metric, kind, k):
    rng = np.random.default_rng(sum(map(ord, f"{metric}{kind}{k}")))
    Q = _data(kind, rng, (37, 24))
    X = _data(kind, rng, (1500, 24))
    wd, wi = jx_stream.stream_topk(jnp.asarray(Q), jnp.asarray(X), k=k,
                                   metric=metric, interpret=True)
    gd, gi = stream_topk(_t(Q), _t(X), k=k, metric=metric)
    assert gi.dtype == torch.int32 and gd.dtype == torch.float32
    assert_same_ids(wd, wi, gi)
    assert_dists(wd, gd)


def test_stream_topk_valid_and_row_ids():
    rng = np.random.default_rng(7)
    Q = _data("int", rng, (20, 16))
    X = _data("int", rng, (700, 16))
    valid = rng.random(700) < 0.6
    row_ids = rng.permutation(700).astype(np.int32) + 1000
    wd, wi = jx_stream.stream_topk(jnp.asarray(Q), jnp.asarray(X), k=15,
                                   valid=jnp.asarray(valid),
                                   row_ids=jnp.asarray(row_ids),
                                   interpret=True)
    gd, gi = stream_topk(_t(Q), _t(X), k=15, valid=_t(valid),
                         row_ids=_t(row_ids))
    assert_same_ids(wd, wi, gi)
    assert_dists(wd, gd)


def test_stream_topk_fewer_valid_than_k_pads():
    rng = np.random.default_rng(8)
    Q = _data("gauss", rng, (5, 8))
    X = _data("gauss", rng, (300, 8))
    valid = np.zeros(300, bool)
    valid[[3, 77, 150]] = True
    wd, wi = jx_stream.stream_topk(jnp.asarray(Q), jnp.asarray(X), k=6,
                                   valid=jnp.asarray(valid), interpret=True)
    gd, gi = stream_topk(_t(Q), _t(X), k=6, valid=_t(valid))
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())
    assert (gi.numpy()[:, 3:] == -1).all()
    assert np.isinf(gd.numpy()[:, 3:]).all()


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_stream_topk_batched_matches_reference(metric):
    rng = np.random.default_rng(9)
    Q = _data("int", rng, (50, 12))
    X = _data("int", rng, (900, 12))
    wd, wi = jx_stream.stream_topk_batched(Q, jnp.asarray(X), k=9,
                                           metric=metric, query_block=16,
                                           interpret=True)
    gd, gi = stream_topk_batched(Q, _t(X), k=9, metric=metric,
                                 query_block=16)
    assert isinstance(gi, np.ndarray)
    assert_same_ids(wd, wi, gi)
    assert_dists(wd, gd)
    td, ti = stream_topk_batched(Q, _t(X), k=9, metric=metric,
                                 query_block=16, materialize=False)
    assert torch.is_tensor(ti)
    np.testing.assert_array_equal(ti.numpy(), gi)


@pytest.mark.parametrize("mode", ["l2sq", "ip", "cos"])
def test_stream_topk_oracles_match_reference(mode):
    rng = np.random.default_rng(10)
    Q = _data("gauss", rng, (17, 20))
    X = _data("gauss", rng, (640, 20))
    wd, wi = jx_stream_ref.stream_topk_ref(jnp.asarray(Q), jnp.asarray(X),
                                           k=12, mode=mode)
    gd, gi = stream_topk_ref(_t(Q), _t(X), k=12, mode=mode)
    assert_same_ids(wd, wi, gi)
    assert_dists(wd, gd)
    sd, si = jx_stream_ref.stream_topk_ref_scan(Q, X, k=12, mode=mode, bn=100)
    hd, hi = stream_topk_ref_scan(_t(Q), _t(X), k=12, mode=mode, bn=100)
    assert_same_ids(sd, si, hi)
    assert_dists(sd, hd)


def test_merge_topk_rounds_matches_reference():
    rng = np.random.default_rng(11)
    d = rng.integers(0, 5, (6, 40)).astype(np.float32)   # many exact ties
    d[rng.random((6, 40)) < 0.2] = np.inf
    ids = rng.permutation(40).astype(np.int32)[None, :].repeat(6, 0)
    wd, wi = jx_merge_rounds(jnp.asarray(d), jnp.asarray(ids), 30)
    gd, gi = merge_topk_rounds(_t(d), _t(ids), 30)
    np.testing.assert_array_equal(np.asarray(wd), gd.numpy())
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())


def test_stream_topk_kernel_rejects_what_it_cannot_take():
    Q = torch.zeros((4, 8))
    X = torch.zeros((100, 8))
    z4, z100 = torch.zeros(4), torch.zeros(100)
    with pytest.raises(ValueError, match="k <="):
        stream_topk_kernel(Q, X, z4, z100, mode="l2sq", k=257)
    with pytest.raises(ValueError, match="CUDA"):
        stream_topk_kernel(Q, X, z4, z100, mode="l2sq", k=10)
    assert stream_topk_kernel.launches == 0


# ------------------------------------------------------- kernel 2: rerank
def _rerank_case(metric, kind="gauss", b=9, C=150, n=260, d=18, seed=0,
                 mask_frac=0.15):
    """-1 slots and duplicate ids that straddle candidate blocks."""
    rng = np.random.default_rng(seed)
    if metric == "hamming":
        X = rng.integers(0, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)
        Q = rng.integers(0, 2**32, (b, 4), dtype=np.uint64).astype(np.uint32)
    else:
        X = _data(kind, rng, (n, d))
        Q = _data(kind, rng, (b, d))
        if metric == "angular" and kind == "gauss":
            X /= np.linalg.norm(X, axis=1, keepdims=True)
            Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    cand = rng.integers(0, n, (b, C)).astype(np.int32)
    if C >= 90:
        cand[:, 50:70] = cand[:, 0:20]
        cand[:, -20:] = cand[:, 0:20]
    cand[rng.random((b, C)) < mask_frac] = -1
    return Q, X, cand


def _port_X(X):
    from repro_torch.bits import words_to_tensor

    return words_to_tensor(X, "cpu") if X.dtype == np.uint32 else _t(X)


def _xsq(X, metric):
    if metric != "euclidean":
        return None, None
    jx = jnp.sum(jnp.asarray(X) ** 2, axis=1)
    return jx, torch.sum(_t(X) ** 2, dim=1)


@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
@pytest.mark.parametrize("kind", ["int", "gauss"])
def test_rerank_kernel_path_matches_reference(metric, kind):
    Q, X, cand = _rerank_case(metric, kind, seed=3)
    jxsq, txsq = _xsq(X, metric)
    wd, wi = jx_rerank.rerank_topk(jnp.asarray(Q), jnp.asarray(X),
                                   jnp.asarray(cand), k=11, metric=metric,
                                   xsq=jxsq, block=64, use_kernel=True,
                                   interpret=True)
    gd, gi = rerank_topk(Q, _port_X(X), cand, k=11, metric=metric, xsq=txsq,
                         use_kernel=True)
    assert_same_ids(wd, wi, gi)
    assert_dists(wd, gd, metric)


@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
@pytest.mark.parametrize("block", [32, 50, 1024])
def test_rerank_fold_matches_reference(metric, block):
    Q, X, cand = _rerank_case(metric, seed=4)
    jxsq, txsq = _xsq(X, metric)
    wd, wi = jx_rerank.rerank_topk(jnp.asarray(Q), jnp.asarray(X),
                                   jnp.asarray(cand), k=12, metric=metric,
                                   xsq=jxsq, block=block)
    gd, gi = rerank_topk(Q, _port_X(X), cand, k=12, metric=metric, xsq=txsq,
                         block=block)
    assert_same_ids(wd, wi, gi)
    assert_dists(wd, gd, metric)


@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
def test_rerank_oracle_matches_reference(metric):
    Q, X, cand = _rerank_case(metric, seed=5)
    wd, wi = jx_rerank_ref.rerank_topk_ref(jnp.asarray(Q), jnp.asarray(X),
                                           jnp.asarray(cand), k=10,
                                           metric=metric)
    gd, gi = rerank_topk_ref(Q, _port_X(X), cand, k=10, metric=metric)
    assert_same_ids(wd, wi, gi)
    assert_dists(wd, gd, metric)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rerank_valid_and_row_ids_match_reference(use_kernel):
    Q, X, cand = _rerank_case("euclidean", "int", seed=6)
    rng = np.random.default_rng(6)
    valid = rng.random(cand.shape) < 0.7
    row_ids = rng.permutation(X.shape[0]).astype(np.int32)
    jxsq, txsq = _xsq(X, "euclidean")
    wd, wi = jx_rerank.rerank_topk(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(cand), k=8,
        metric="euclidean", xsq=jxsq, valid=jnp.asarray(valid),
        row_ids=jnp.asarray(row_ids), block=64, use_kernel=use_kernel,
        interpret=True)
    gd, gi = rerank_topk(Q, _t(X), cand, k=8, metric="euclidean", xsq=txsq,
                         valid=_t(valid), row_ids=_t(row_ids),
                         use_kernel=use_kernel)
    assert_same_ids(wd, wi, gi)
    assert_dists(wd, gd)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rerank_short_window_pads(use_kernel):
    Q, X, cand = _rerank_case("angular", seed=7, C=12, mask_frac=0.5)
    wd, wi = jx_rerank.rerank_topk(jnp.asarray(Q), jnp.asarray(X),
                                   jnp.asarray(cand), k=10, metric="angular",
                                   use_kernel=use_kernel, interpret=True)
    gd, gi = rerank_topk(Q, _t(X), cand, k=10, metric="angular",
                         use_kernel=use_kernel)
    assert_same_ids(wd, wi, gi)
    assert_dists(wd, gd)
    assert (gi.numpy() == -1).any()


def test_merge_topk_unique_rounds_matches_reference():
    rng = np.random.default_rng(12)
    d = rng.integers(0, 4, (5, 60)).astype(np.float32)
    ids = rng.integers(0, 25, (5, 60)).astype(np.int32)   # many duplicates
    masked = rng.random((5, 60)) < 0.2
    d[masked] = np.inf
    ids[masked] = -1
    wd, wi = jx_merge_unique(jnp.asarray(d), jnp.asarray(ids), 20)
    gd, gi = merge_topk_unique_rounds(_t(d), _t(ids), 20)
    np.testing.assert_array_equal(np.asarray(wd), gd.numpy())
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())


def test_rerank_kernel_rejects_what_it_cannot_take():
    rows = torch.zeros((2, 5), dtype=torch.int32)
    Q, X = torch.zeros((2, 8)), torch.zeros((10, 8))
    qsq, pen = torch.zeros(2), torch.zeros((2, 5))
    with pytest.raises(ValueError, match="k <="):
        rerank_topk_kernel(rows, Q, qsq, rows, pen, X, mode="l2sq", k=300)
    with pytest.raises(ValueError, match="CUDA"):
        rerank_topk_kernel(rows, Q, qsq, rows, pen, X, mode="l2sq", k=3)
    assert rerank_topk_kernel.launches == 0
