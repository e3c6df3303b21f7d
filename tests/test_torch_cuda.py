"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a CUDA card (marker ``cuda``; skipped without a card and
nvcc).  Run on the card with:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Small shapes with ragged edges (nq, n, C not multiples of the tiles).
Tolerances: float distances rtol=1e-5, atol=1e-4; hamming distances and
every id on integer-valued inputs bitwise; the ADC scan bitwise (kernel
and plain version add the subspaces in the same order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    return torch.device("cuda")


def _ints(rng, shape):
    return torch.as_tensor(rng.integers(-3, 4, shape).astype(np.float32))


@pytest.mark.parametrize("mode", ["l2sq", "ip", "cos"])
@pytest.mark.parametrize("k", [1, 10, 100, 256])
def test_stream_topk_kernel_matches_plain(cuda, mode, k):
    from repro_torch.kernels.distance_topk import (stream_topk_kernel,
                                                   stream_topk_plain)
    from repro_torch.kernels.distance_topk.ops import _corpus_row, _query_col

    rng = np.random.default_rng(k)
    Q = _ints(rng, (131, 37)).to(cuda)
    X = _ints(rng, (5003, 37)).to(cuda)
    qsq, xsq = _query_col(Q, mode), _corpus_row(X, mode)
    masked = torch.as_tensor(rng.random(5003) < 0.1).to(cuda)
    xsq[masked] = float("inf")                          # masked rows
    before = stream_topk_kernel.launches
    gd, gi = stream_topk_kernel(Q, X, qsq, xsq, mode=mode, k=k)
    torch.cuda.synchronize()
    assert stream_topk_kernel.launches == before + 1
    wd, wi = stream_topk_plain(Q, X, qsq, xsq, mode=mode, k=k, bn=1000)
    torch.testing.assert_close(gd, wd, rtol=0, atol=0)
    assert torch.equal(gi, wi)


@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_rerank_topk_kernel_matches_plain(cuda, metric, k):
    from repro_torch.bits import words_to_tensor
    from repro_torch.kernels.rerank_topk import (rerank_topk_kernel,
                                                 rerank_topk_plain)
    from repro_torch.kernels.rerank_topk.ops import kernel_operands

    rng = np.random.default_rng(k + 7)
    b, C, n = 37, 1301, 900
    if metric == "hamming":
        X = words_to_tensor(rng.integers(0, 2**32, (n, 5), dtype=np.uint64)
                            .astype(np.uint32), cuda)
        Q = words_to_tensor(rng.integers(0, 2**32, (b, 5), dtype=np.uint64)
                            .astype(np.uint32), cuda)
        qsq = xsq = None
    else:
        X = _ints(rng, (n, 33)).to(cuda)
        Q = _ints(rng, (b, 33)).to(cuda)
        qsq = torch.sum(Q * Q, dim=1, keepdim=True) \
            if metric == "euclidean" else None
        xsq = torch.sum(X * X, dim=1) if metric == "euclidean" else None
    cand = torch.as_tensor(rng.integers(0, n, (b, C)).astype(np.int32))
    cand[:, 600:700] = cand[:, :100]               # duplicates far apart
    bad = torch.as_tensor(rng.random((b, C)) < 0.2)
    cand, bad = cand.to(cuda), bad.to(cuda)
    row_ids = torch.as_tensor(rng.permutation(n).astype(np.int32)).to(cuda)
    ops = kernel_operands(Q, X, qsq, xsq, cand, bad, row_ids, metric, k)
    gd, gi = rerank_topk_kernel(**ops)
    torch.cuda.synchronize()
    wd, wi = rerank_topk_plain(**ops)
    torch.testing.assert_close(gd, wd, rtol=0, atol=0)
    assert torch.equal(gi, wi)
    assert len(set(gi[0].tolist()) - {-1}) == int((gi[0] >= 0).sum())


@pytest.mark.parametrize("k", [1, 10, 100, 256])
@pytest.mark.parametrize("w,n,n_valid", [(8, 5003, 5003), (5, 1000, 937),
                                         (40, 700, 700)])
def test_hamming_topk_kernel_matches_plain(cuda, k, w, n, n_valid):
    from repro_torch.bits import words_to_tensor
    from repro_torch.kernels.hamming import (hamming_topk_kernel,
                                             hamming_topk_plain)

    rng = np.random.default_rng(k + w)
    X = words_to_tensor(rng.integers(0, 2**32, (n, w), dtype=np.uint64)
                        .astype(np.uint32), cuda)
    Q = torch.cat([X[:40], words_to_tensor(
        rng.integers(0, 2**32, (91, w), dtype=np.uint64).astype(np.uint32),
        cuda)])                              # exact matches and strangers
    before = hamming_topk_kernel.launches
    gd, gi = hamming_topk_kernel(Q, X, n_valid, k=k)
    torch.cuda.synchronize()
    assert hamming_topk_kernel.launches == before + 1
    wd, wi = hamming_topk_plain(Q, X, n_valid, k=k, bn=1000)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)
    assert (gi < n_valid).all()


@pytest.mark.parametrize("C", [1, 10, 256, 1024])
@pytest.mark.parametrize("b,n,m,K", [(37, 3001, 16, 256), (5, 2000, 8, 64),
                                     (9, 1500, 128, 256), (3, 700, 960, 256)])
def test_adc_scan_kernel_matches_plain(cuda, C, b, n, m, K):
    """PQ (16-byte code loads), a byte-path width, the int8 table (128 KB:
    one query per block) and a table too large for shared memory (read
    through the caches); small-integer tables make many exact ties."""
    from repro_torch.kernels.adc_scan import adc_scan_kernel, adc_scan_plain

    rng = np.random.default_rng(C + m)
    codes = torch.as_tensor(rng.integers(0, K, (n, m)).astype(np.uint8))
    luts = torch.as_tensor(rng.integers(0, 7, (b, m, K)).astype(np.float32))
    codes, luts = codes.to(cuda), luts.to(cuda)
    k = min(C, n)
    before = adc_scan_kernel.launches
    gd, gi = adc_scan_kernel(codes, luts, k=k)
    torch.cuda.synchronize()
    assert adc_scan_kernel.launches == before + 1
    wd, wi = adc_scan_plain(codes, luts, k=k)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)
    noisy = luts + torch.rand(luts.shape, device=cuda)
    gd, gi = adc_scan_kernel(codes, noisy, k=k)
    wd, wi = adc_scan_plain(codes, noisy, k=k)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)


def test_adc_scan_kernel_refuses_c_above_limit(cuda):
    from repro_torch.kernels.adc_scan import MAX_C, adc_scan_kernel

    codes = torch.zeros((2000, 16), dtype=torch.uint8, device=cuda)
    luts = torch.zeros((2, 16, 256), device=cuda)
    with pytest.raises(ValueError, match=str(MAX_C)):
        adc_scan_kernel(codes, luts, k=MAX_C + 1)


def test_entry_points_run_on_cuda_by_default(cuda):
    from repro_torch.ann import bruteforce

    rng = np.random.default_rng(0)
    X = rng.standard_normal((300, 16)).astype(np.float32)
    st = bruteforce.build(X, metric="euclidean", backend="pallas")
    assert st["X"].is_cuda
    d, i = bruteforce.search(st, X[:5], k=3)
    assert i.is_cuda and (i[:, 0].cpu().numpy() == np.arange(5)).all()


def test_new_paths_run_their_kernels_on_cuda(cuda):
    from repro_torch.ann import bruteforce, hamming
    from repro_torch.kernels.adc_scan import adc_scan_kernel
    from repro_torch.kernels.hamming import hamming_topk_kernel

    rng = np.random.default_rng(1)
    X = rng.standard_normal((3000, 32)).astype(np.float32)
    st = bruteforce.build(X, quantize={"pq": {"m": 8, "bits": 8}},
                          adc_kernel=True)
    before = adc_scan_kernel.launches
    d, i = bruteforce.search(st, X[:5], k=3, n_cand=50)
    assert adc_scan_kernel.launches == before + 1
    assert i.is_cuda and (i[:, 0].cpu().numpy() == np.arange(5)).all()
    codes = rng.integers(0, 2**32, (3000, 8), dtype=np.uint64).astype(
        np.uint32)
    st = hamming.bruteforce_build(codes, backend="pallas")
    before = hamming_topk_kernel.launches
    d, i = hamming.bruteforce_search(st, codes[:5], k=3)
    assert hamming_topk_kernel.launches == before + 1
    assert (i[:, 0].cpu().numpy() == np.arange(5)).all()
    assert (d[:, 0] == 0).all()
