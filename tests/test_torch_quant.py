"""Compressed-domain search of the port against the JAX package on the same
numpy inputs: the codecs (``quant/codec.py``), the ADC scan
(``kernels/adc_scan``: ``adc_scan``, ``adc_window_topk``,
``pick_adc_block``; the kernel route runs its plain version on CPU
tensors, the reference's Pallas kernel runs in interpret mode) and the
``quantize=`` paths of BruteForce and IVF.

Tolerances:
  * int8 codes and codebooks: bitwise (the same numpy code);
  * PQ codebooks: the k-means tolerance of the first slice (rtol=1e-4,
    atol=1e-4, assignments equal for >= 99.9 % of the points), since the
    port sums centers in another order;
  * LUTs: rtol=1e-5, atol=1e-5;
  * ADC distances: rtol=1e-5, atol=1e-5 (the port sums subspaces in index
    order, XLA in its own); ADC ids bitwise outside the reference's near
    ties (adjacent distances within 1e-4); swaps at near ties are counted
    and allowed, since the reassociated sums may order such a pair either
    way;
  * inside the port, fold, kernel route and oracle sum in the same order:
    bitwise;
  * the traced ``n_cand`` mask equals the static window bitwise (the ADC
    prefix); the searches then give the same ids bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import quant as jx_quant  # noqa: E402
from repro.ann import bruteforce as jx_bf  # noqa: E402
from repro.ann import ivf as jx_ivf  # noqa: E402
from repro.kernels import adc_scan as jx_adc  # noqa: E402
from repro.kernels.adc_scan.ref import adc_scan_ref as jx_adc_ref  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.ann import bruteforce as bf  # noqa: E402
from repro_torch.ann import ivf  # noqa: E402
from repro_torch.convert import state_from_reference  # noqa: E402
from repro_torch.kernels.adc_scan import (MAX_C, adc_scan,  # noqa: E402
                                          adc_scan_kernel, adc_scan_plain,
                                          adc_scan_ref, adc_window_topk,
                                          pick_adc_block)
from repro_torch.kernels.adc_scan.adc_scan import plan  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
PQ = {"pq": {"m": 8, "bits": 6}}
CODECS = [PQ, "int8"]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((700, 16)).astype(np.float32)
    Q = (X[rng.integers(0, 700, 24)]
         + 0.2 * rng.standard_normal((24, 16))).astype(np.float32)
    return X, Q


def _carry(ref, **static):
    return state_from_reference(
        ref.algo, ref.metric, {k: np.asarray(v) for k, v in ref.arrays.items()},
        dict(ref.static, **static), device="cpu")


def assert_same_ids(want_d, want_i, got_i, atol=ATOL):
    """ids bitwise outside the reference's near ties; returns the number
    of swaps at near ties."""
    want_d, want_i, got_i = (np.asarray(a) for a in (want_d, want_i, got_i))
    assert want_i.shape == got_i.shape
    bad = want_i != got_i
    near = np.zeros_like(bad)
    gap = np.abs(np.diff(want_d, axis=1)) <= atol
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert int((bad & ~near).sum()) == 0, "id mismatches outside near ties"
    return int((bad & near).sum())


# ----------------------------------------------------------------- codec
@pytest.mark.parametrize("spec", [
    "pq", "int8", {"pq": {"m": 4}}, ("pq", {"bits": 3}), {"int8": {}},
    "opq", {"pq": {"m": 4}, "int8": {}}, {"int8": {"m": 2}},
    {"pq": {"mm": 4}}, {"pq": {"bits": 9}}, {"pq": {"m": 0}}, 3])
def test_normalize_quantize_matches_reference(spec):
    try:
        want = jx_quant.normalize_quantize(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            quant.normalize_quantize(spec)
        assert str(got.value) == str(e)
        return
    assert quant.normalize_quantize(spec) == want


def test_subspace_split_and_bytes(corpus):
    X, _ = corpus
    for m in (3, 4, 16):
        np.testing.assert_array_equal(quant.subspace_split(X, m),
                                      jx_quant.subspace_split(X, m))
    assert quant.bytes_per_vector(("pq", 8, 6)) == 8
    assert quant.bytes_per_vector(("int8", 24, 8)) == 24


def test_int8_codes_bitwise(corpus):
    X, _ = corpus
    want, wstatic = jx_quant.train_codec(X, "int8", metric="euclidean")
    got, gstatic = quant.train_codec(X, "int8", metric="euclidean",
                                     device="cpu")
    assert gstatic == wstatic
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(want["codes"]))
    np.testing.assert_array_equal(got["codebooks"].numpy(),
                                  np.asarray(want["codebooks"]))


@pytest.mark.parametrize("m", [8, 5])
def test_pq_codebooks_within_kmeans_tolerance(corpus, m):
    """m = 5 does not divide d = 16: the zero-padded tail subspace takes
    the constant-subspace branch."""
    X, _ = corpus
    spec = {"pq": {"m": m, "bits": 6, "iters": 5}}
    want, wstatic = jx_quant.train_codec(X, spec, metric="euclidean")
    got, gstatic = quant.train_codec(X, spec, metric="euclidean",
                                     device="cpu")
    assert gstatic == wstatic
    np.testing.assert_allclose(got["codebooks"].numpy(),
                               np.asarray(want["codebooks"]), rtol=1e-4,
                               atol=1e-4)
    agree = np.mean(got["codes"].numpy() == np.asarray(want["codes"]))
    assert agree >= 0.999


def test_train_codec_rejects_hamming(corpus):
    with pytest.raises(ValueError, match="float metric"):
        quant.train_codec(corpus[0], "pq", metric="hamming", device="cpu")


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("spec", CODECS)
def test_luts_and_decode_match_reference(corpus, metric, spec):
    X, Q = corpus
    arrays, _ = jx_quant.train_codec(X, spec, metric=metric)
    cb = torch.as_tensor(np.asarray(arrays["codebooks"]))
    want = jx_quant.build_luts(arrays["codebooks"], jnp.asarray(Q), metric)
    luts = quant.build_luts(cb, Q, metric)
    np.testing.assert_allclose(luts.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    rec = quant.decode(cb, np.asarray(arrays["codes"]), d=X.shape[1])
    np.testing.assert_array_equal(
        rec.numpy(), np.asarray(jx_quant.decode(arrays["codebooks"],
                                                arrays["codes"], d=16)))
    # the LUT sum is the distance to the decoded vector
    adc = adc_scan_ref(torch.as_tensor(np.asarray(arrays["codes"])), luts,
                       k=X.shape[0])
    r = rec.numpy().astype(np.float64)
    full = ((Q[:, None, :] - r[None]) ** 2).sum(-1) if metric == "euclidean" \
        else 1.0 - Q @ r.T
    np.testing.assert_allclose(
        np.take_along_axis(full, adc[1].numpy().astype(np.int64), axis=1),
        adc[0].numpy(), rtol=1e-4, atol=1e-4)


# -------------------------------------------------------------- ADC scan
@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("spec", CODECS)
@pytest.mark.parametrize("k", [1, 37, 300])
def test_adc_scan_matches_reference(corpus, metric, spec, k):
    """Reference oracle, fold and Pallas kernel (interpret) against the
    port's oracle, fold and kernel route (plain version on the CPU)."""
    X, Q = corpus
    arrays, _ = jx_quant.train_codec(X, spec, metric=metric)
    jl = jx_quant.build_luts(arrays["codebooks"], jnp.asarray(Q), metric)
    codes = torch.as_tensor(np.asarray(arrays["codes"]))
    luts = torch.as_tensor(np.array(jl))                 # the same tables
    want = jx_adc_ref(arrays["codes"], jl, k=k)
    want_kernel = jx_adc.adc_scan(arrays["codes"], jl, k=k, block=64,
                                  use_kernel=True, interpret=True)
    ref = adc_scan_ref(codes, luts, k=k)
    fold = adc_scan(codes, luts, k=k, block=64)
    kern = adc_scan(codes, luts, k=k, use_kernel=True)
    for got in (fold, kern):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for w in (want, want_kernel):
        np.testing.assert_allclose(ref[0].numpy(), np.asarray(w[0]),
                                   rtol=1e-5, atol=1e-5)
        assert_same_ids(w[0], w[1], ref[1])


def test_adc_plain_tiles_agree():
    """The kernel's plain version gives the oracle's answer at any tile
    and query-block size (ragged last tiles included)."""
    rng = np.random.default_rng(3)
    codes = torch.as_tensor(rng.integers(0, 32, (1003, 6)).astype(np.uint8))
    luts = torch.as_tensor(rng.integers(0, 9, (11, 6, 32)).astype(np.float32))
    want = adc_scan_ref(codes, luts, k=50)
    for bq, budget in [(1024, 1 << 28), (4, 4 * 4 * 6 * 300)]:
        got = adc_scan_plain(codes, luts, k=50, bq=bq, budget=budget)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_adc_kernel_route_refuses_c_above_its_limit(corpus):
    X, Q = corpus
    arrays, _ = quant.train_codec(X, PQ, metric="euclidean", device="cpu")
    luts = quant.build_luts(arrays["codebooks"], Q, "euclidean")
    with pytest.raises(ValueError, match=str(MAX_C)):
        adc_scan(torch.cat([arrays["codes"]] * 2), luts, k=MAX_C + 1,
                 use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        adc_scan_kernel(arrays["codes"], luts, k=10)
    # the fold has no such limit
    assert adc_scan(torch.cat([arrays["codes"]] * 2), luts,
                    k=MAX_C + 1)[1].shape == (Q.shape[0], MAX_C + 1)


@pytest.mark.parametrize("b,n,m,K,C", [
    (4096, 10**6, 16, 256, 10), (4096, 10**6, 16, 256, 1024),
    (4096, 10**6, 128, 256, 1024), (1, 10**6, 16, 256, 100),
    (10, 5000, 960, 256, 100)])
def test_adc_plan_fits_the_card(b, n, m, K, C):
    """Block shapes stay within sm_90's shared memory, cover the corpus,
    and send a table too large for shared memory through the caches."""
    p = plan(b, n, m, K, C, sms=132)
    assert 1 <= p["G"] <= 8 and p["smem"] <= 232448
    assert p["P"] >= C and p["BUF"] >= max(p["P"], 512)
    assert p["splits"] * p["rows"] >= n > (p["splits"] - 1) * p["rows"]
    assert p["lut_smem"] == (4 * m * K + 8 * (p["P"] + p["BUF"]) + 4
                             <= 232448)


@pytest.mark.parametrize("args", [(8, 50, 16, 10), (4096, 10**6, 16, 1000),
                                  (10**4, 25000, 128, 100), (1, 3, 8, 1)])
def test_pick_adc_block_matches_reference(args):
    assert pick_adc_block(*args) == jx_adc.pick_adc_block(*args)


def test_adc_window_matches_reference(corpus):
    """-1 candidates and a valid= mask never win; a window shorter than k
    pads (+inf, -1) -- rerank_topk's masking contract."""
    X, Q = corpus
    arrays, _ = jx_quant.train_codec(X, PQ, metric="euclidean")
    jl = jx_quant.build_luts(arrays["codebooks"], jnp.asarray(Q), "euclidean")
    rng = np.random.default_rng(4)
    cand = rng.integers(0, 700, (Q.shape[0], 90)).astype(np.int32)
    cand[:, 70:] = -1
    cand[:, 40:50] = cand[:, :10]                       # duplicates
    valid = rng.random(cand.shape) < 0.8
    want = jx_adc.adc_window_topk(arrays["codes"], jl, jnp.asarray(cand),
                                  k=30, valid=jnp.asarray(valid), block=16)
    got = adc_window_topk(torch.as_tensor(np.asarray(arrays["codes"])),
                          torch.as_tensor(np.array(jl)), cand, k=30,
                          valid=valid, block=16)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    assert_same_ids(want[0], want[1], got[1])
    short = adc_window_topk(torch.as_tensor(np.asarray(arrays["codes"])),
                            torch.as_tensor(np.array(jl)), cand[:, 65:75],
                            k=8)
    assert (short[1][:, 5:] == -1).all() and torch.isinf(short[0][:, 5:]).all()


# ---------------------------------------------- quantized BruteForce / IVF
@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("spec", CODECS)
@pytest.mark.parametrize("keep_fp32", [True, False])
def test_quantized_bruteforce_on_reference_state(corpus, metric, spec,
                                                 keep_fp32):
    X, Q = corpus
    ref = jx_bf.build(X, metric=metric, quantize=spec, keep_fp32=keep_fp32)
    for kernels in (False, True):
        st = _carry(ref, adc_kernel=kernels, rerank_kernel=kernels)
        for kw in ({"n_cand": 40}, {"n_cand": None},
                   {"n_cand": 25, "max_cand": 60}):
            if kernels and kw["n_cand"] is None:
                continue                     # C = n exceeds no limit here,
                # but is covered by the refusal test below
            want = jx_bf.search(ref, jnp.asarray(Q), k=10, **kw)
            got = bf.search(st, Q, k=10, **kw)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       rtol=1e-5, atol=1e-5)
            assert_same_ids(want[0], want[1], got[1])


def test_quantized_bruteforce_kernel_refuses_full_scan(corpus):
    """n_cand=None with adc_kernel scans with C = n; above the kernel's
    limit that raises instead of falling back."""
    X, Q = corpus
    Xb = np.concatenate([X, X[::-1] + 0.01])            # n = 1400 > 1024
    st = bf.build(Xb, quantize=PQ, adc_kernel=True, device="cpu")
    with pytest.raises(ValueError, match="at most 1024"):
        bf.search(st, Q, k=10)
    assert bf.search(st, Q, k=10, n_cand=MAX_C)[1].shape == (Q.shape[0], 10)


@pytest.mark.parametrize("adc_kernel", [False, True])
def test_traced_n_cand_equals_static_window(corpus, adc_kernel):
    """The ADC output is sorted by (dist, row), so the first n_cand entries
    of the top-max_cand scan ARE the static top-n_cand window, bitwise; the
    search then gives the static ids bitwise (its rerank distances to the
    tolerance: the fold's matmul sees another window shape)."""
    X, Q = corpus
    st = bf.build(X, quantize=PQ, adc_kernel=adc_kernel, device="cpu")
    luts = quant.build_luts(st["codebooks"], Q, "euclidean")
    wide = adc_scan(st["codes"], luts, k=64, use_kernel=adc_kernel)
    for n_cand in (10, 20, 64):
        narrow = adc_scan(st["codes"], luts, k=n_cand, use_kernel=adc_kernel)
        assert torch.equal(wide[0][:, :n_cand], narrow[0])
        assert torch.equal(wide[1][:, :n_cand], narrow[1])
        want = bf.search(st, Q, k=10, n_cand=n_cand)
        got = bf.search(st, Q, k=10, n_cand=torch.tensor(n_cand),
                        max_cand=64)
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    st = ivf.build(X, n_clusters=8, quantize=PQ, device="cpu")
    for n_cand in (10, 30):
        want = ivf.search(st, Q, k=10, n_probes=3, n_cand=n_cand)
        got = ivf.search(st, Q, k=10, n_probes=3,
                         n_cand=torch.tensor(n_cand), max_cand=30)
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("keep_fp32", [True, False])
@pytest.mark.parametrize("rerank_kernel", [False, True])
def test_quantized_ivf_on_reference_state(corpus, metric, keep_fp32,
                                          rerank_kernel):
    X, Q = corpus
    ref = jx_ivf.build(X, metric=metric, n_clusters=8, quantize=PQ,
                       keep_fp32=keep_fp32)
    st = _carry(ref, rerank_kernel=rerank_kernel)
    for kw in ({"n_probes": 2, "n_cand": 30}, {"n_probes": 3},
               {"n_probes": 2, "max_probes": 4, "n_cand": 20,
                "max_cand": 50}):
        want = jx_ivf.search(ref, jnp.asarray(Q), k=10, **kw)
        got = ivf.search(st, Q, k=10, **kw)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
        assert_same_ids(want[0], want[1], got[1])


def test_quantized_builds_mirror_reference_layout(corpus):
    X, _ = corpus
    for mod, port, kw in ((jx_bf, bf, {}), (jx_ivf, ivf, {"n_clusters": 8})):
        for keep in (True, False):
            ref = mod.build(X, quantize="int8", keep_fp32=keep, **kw)
            st = port.build(X, quantize="int8", keep_fp32=keep,
                            device="cpu", **kw)
            assert set(st.arrays) == set(ref.arrays)
            assert st.static == ref.static
            np.testing.assert_array_equal(st["codes"].numpy(),
                                          np.asarray(ref["codes"]))
    with pytest.raises(ValueError, match="streaming"):
        bf.build(X, backend="pallas", streaming=True, quantize="pq",
                 device="cpu")
    st = bf.build(X, quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="live"):
        bf.search(st, X[:2], k=3, live=np.ones(len(X), bool))
    st = ivf.build(X, n_clusters=4, device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        ivf.search(st, X[:2], k=3, n_cand=5)
