"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a CUDA card (marker ``cuda``; skipped without a card and
nvcc).  Run on the card with:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Small shapes with ragged edges (nq, n, C not multiples of the tiles).
Tolerances: float distances rtol=1e-5, atol=1e-4; hamming distances and
every id on integer-valued inputs bitwise; the ADC scan bitwise (kernel
and plain version add the subspaces in the same order).  Kernel 2's two
entries on N(0, 1) inputs: bit for bit with each other, and within
``chip_smoke.py``'s gate of the plain version (distances within 2e-3, no
id mismatch outside near ties); on N(0, 9) inputs at d = 128, within
``rerank_topk.EXACT_REL`` of the exact value (the cross term in fp64).
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
    from repro_torch.kernels.distance.distance import norm_operand

    rng = np.random.default_rng(k)
    Q = _ints(rng, (131, 37)).to(cuda)
    X = _ints(rng, (5003, 37)).to(cuda)
    qsq, xsq = norm_operand(Q, mode), norm_operand(X, mode)
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


@pytest.mark.parametrize("C", [1, 10, 256, 1000, 1024])
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


def _adc_variants(cuda, codes, luts, C, pins):
    """The kernel under each pinned plan against the plain version, bit for
    bit, on the tables and on the tables plus uniform noise."""
    from repro_torch.kernels.adc_scan import adc_scan_kernel, adc_scan_plain
    from repro_torch.kernels.adc_scan.adc_scan import blocks_per_sm, plan

    n, m = codes.shape
    b, _, K = luts.shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for tables in (luts, luts + torch.rand(luts.shape, device=cuda)):
        wd, wi = adc_scan_plain(codes, tables, k=C)
        for pin in pins:
            p = plan(b, n, m, K, C, sms, occupancy=blocks_per_sm, **pin)
            gd, gi = adc_scan_kernel(codes, tables, k=C, plan=p)
            torch.cuda.synchronize()
            assert torch.equal(gd, wd) and torch.equal(gi, wi), p


@pytest.mark.parametrize("C", [1, 10, 256, 1000, 1024])
@pytest.mark.parametrize("G,R,threads", [(4, 1, 256), (1, 1, 256)])
def test_adc_scan_variants_match_plain(cuda, G, R, threads, C):
    """Every compiled variant of 256 threads with small tables in shared
    memory (G queries a block, their tables interleaved) bit for bit with
    the plain version: 37 queries (a tail group at G = 4), PQ m = 16 over
    5,001 rows in one range and in three; small-integer tables (many exact
    ties), then noisy ones."""
    rng = np.random.default_rng(10 * G + R + C + threads)
    codes = torch.as_tensor(rng.integers(0, 256, (5001, 16)).astype(
        np.uint8)).to(cuda)
    luts = torch.as_tensor(rng.integers(0, 7, (37, 16, 256)).astype(
        np.float32)).to(cuda)
    _adc_variants(cuda, codes, luts, C, [
        dict(G=G, R=R, threads=threads, splits=1),
        dict(G=G, R=R, threads=threads, splits=3)])


@pytest.mark.parametrize("m,R,threads", [(128, 1, 256), (128, 2, 1024),
                                         (960, 1, 256)])
def test_adc_scan_one_query_variants_match_plain(cuda, m, R, threads):
    """One query a block: the int8 table at d = 128 (128 KB in shared
    memory, 256 and 1,024 threads) and at d = 960 (through the caches),
    C = 10 and 1000, in one range and in the plan's."""
    rng = np.random.default_rng(m + R + threads)
    codes = torch.as_tensor(rng.integers(0, 256, (2500, m)).astype(
        np.uint8)).to(cuda)
    luts = torch.as_tensor(rng.integers(0, 7, (5, m, 256)).astype(
        np.float32)).to(cuda)
    for C in (10, 1000):
        _adc_variants(cuda, codes, luts, C, [
            dict(G=1, R=R, threads=threads, splits=1),
            dict(G=1, R=R, threads=threads)])


def test_adc_scan_kernel_refuses_a_plan_for_other_operands(cuda):
    """A plan made for fewer rows would leave the last rows unscanned: the
    wrapper refuses it before a launch."""
    from repro_torch.kernels.adc_scan import adc_scan_kernel
    from repro_torch.kernels.adc_scan.adc_scan import blocks_per_sm, plan

    codes = torch.zeros((5000, 16), dtype=torch.uint8, device=cuda)
    luts = torch.zeros((8, 16, 256), device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = plan(8, 1000, 16, 256, 10, sms, occupancy=blocks_per_sm)
    with pytest.raises(ValueError, match="does not fit"):
        adc_scan_kernel(codes, luts, k=10, plan=p)


def test_adc_plan_occupancy_model_is_a_lower_bound(cuda):
    """The plan's occupancy model (launch bounds and shared memory) never
    promises more resident blocks than the occupancy calculator grants."""
    from repro_torch.kernels.adc_scan.adc_scan import (
        VARIANTS, blocks_per_sm, model_blocks_per_sm)

    for G, R, threads, lut_smem in VARIANTS:
        for smem in (5_124, 40_000, 81_000, 164_896, 229_408):
            assert model_blocks_per_sm(G, R, threads, lut_smem, smem) <= \
                blocks_per_sm(G, R, threads, lut_smem, smem)


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


# ------------------------------------------- kernels 5-7 and the k / C routes
def _bf16_ulps(got, want):
    """Largest distance between bf16 tensors in units of want's last place
    (a bf16 ulp at |w| is 2**(floor(log2 |w|) - 7))."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    mag = torch.clamp_min(w.abs(), 2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max())


@pytest.mark.parametrize("mode", ["l2sq", "ip", "cos"])
@pytest.mark.parametrize("kind", ["int", "gauss"])
def test_distance_matrix_kernel_matches_plain(cuda, mode, kind):
    from repro_torch.kernels.distance import (distance_matrix,
                                              distance_matrix_kernel,
                                              distance_matrix_plain)
    from repro_torch.kernels.distance.distance import norm_operand

    rng = np.random.default_rng(len(mode))
    make = _ints if kind == "int" else (lambda r, s: torch.as_tensor(
        r.standard_normal(s).astype(np.float32)))
    Q, X = make(rng, (131, 37)).to(cuda), make(rng, (5003, 37)).to(cuda)
    qsq, xsq = norm_operand(Q, mode), norm_operand(X, mode)
    before = distance_matrix_kernel.launches
    got = distance_matrix(Q, X, mode=mode)
    torch.cuda.synchronize()
    assert distance_matrix_kernel.launches == before + 1
    want = distance_matrix_plain(Q, X, qsq, xsq, mode=mode)
    if kind == "int":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["l2sq", "ip", "cos"])
def test_distance_route_equals_stream_kernel_bitwise(cuda, mode):
    """At k = 256 the streaming kernel and the distances-out route through
    kernel 5 give the same distances and ids, bit for bit."""
    from repro_torch.kernels.distance_topk import stream_topk_kernel
    from repro_torch.kernels.distance.distance import norm_operand
    from repro_torch.kernels.distance_topk.ops import distances_route

    rng = np.random.default_rng(5)
    Q = torch.as_tensor(rng.standard_normal((77, 45)).astype(np.float32))
    X = torch.as_tensor(rng.standard_normal((6001, 45)).astype(np.float32))
    Q, X = Q.to(cuda), X.to(cuda)
    if mode == "cos":
        Q, X = Q / Q.norm(dim=1, keepdim=True), X / X.norm(dim=1, keepdim=True)
    qsq, xsq = norm_operand(Q, mode), norm_operand(X, mode)
    xsq[torch.as_tensor(rng.random(6001) < 0.1).to(cuda)] = float("inf")
    a = stream_topk_kernel(Q, X, qsq, xsq, mode=mode, k=256)
    b = distances_route(Q, X, qsq, xsq, mode=mode, k=256)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("k", [257, 1000])
def test_stream_topk_above_max_k_matches_plain(cuda, k):
    from repro_torch.kernels.distance import distance_matrix_kernel
    from repro_torch.kernels.distance_topk import (stream_topk,
                                                   stream_topk_plain)
    from repro_torch.kernels.distance.distance import norm_operand

    rng = np.random.default_rng(k)
    Q, X = _ints(rng, (50, 21)).to(cuda), _ints(rng, (3001, 21)).to(cuda)
    before = distance_matrix_kernel.launches
    gd, gi = stream_topk(Q, X, k=k)
    assert distance_matrix_kernel.launches == before + 1
    wd, wi = stream_topk_plain(Q, X, norm_operand(Q, "l2sq"),
                               norm_operand(X, "l2sq"), mode="l2sq", k=k)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)


@pytest.mark.parametrize("k", [257, 1000])
def test_hamming_topk_above_max_k_matches_plain(cuda, k):
    from repro_torch.bits import words_to_tensor
    from repro_torch.kernels.hamming import (hamming_dist_kernel,
                                             hamming_topk, hamming_topk_plain)

    rng = np.random.default_rng(k)
    X = words_to_tensor(rng.integers(0, 2**32, (2001, 5), dtype=np.uint64)
                        .astype(np.uint32), cuda)
    Q = X[:37].clone()
    before = hamming_dist_kernel.launches
    gd, gi = hamming_topk(Q, X, k=k)
    assert hamming_dist_kernel.launches == before + 1
    wd, wi = hamming_topk_plain(Q, X, 2001, k=k)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)


@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
def test_rerank_topk_above_max_k_matches_plain(cuda, metric):
    from repro_torch.bits import words_to_tensor
    from repro_torch.kernels.rerank_topk import (rerank_dist_kernel,
                                                 rerank_dist_plain,
                                                 rerank_topk,
                                                 rerank_topk_plain)
    from repro_torch.kernels.rerank_topk.ops import kernel_operands

    rng = np.random.default_rng(11)
    b, C, n, k = 21, 1301, 900, 300
    if metric == "hamming":
        X = words_to_tensor(rng.integers(0, 2**32, (n, 5), dtype=np.uint64)
                            .astype(np.uint32), cuda)
        Q = X[:b].clone()
        xsq = None
    else:
        X, Q = _ints(rng, (n, 33)).to(cuda), _ints(rng, (b, 33)).to(cuda)
        xsq = torch.sum(X * X, dim=1) if metric == "euclidean" else None
    cand = torch.as_tensor(rng.integers(-1, n, (b, C)).astype(np.int32))
    cand[:, 600:700] = cand[:, :100]               # duplicates far apart
    cand = cand.to(cuda)
    before = rerank_dist_kernel.launches
    gd, gi = rerank_topk(Q, X, cand, k=k, metric=metric, xsq=xsq,
                         use_kernel=True)
    assert rerank_dist_kernel.launches == before + 1
    qsq = torch.sum(Q * Q, dim=1, keepdim=True) \
        if metric == "euclidean" else None
    ops = kernel_operands(Q, X, qsq, xsq, cand, cand < 0, None, metric, k)
    wd, wi = rerank_topk_plain(**ops)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)
    ops.pop("k")
    assert torch.equal(rerank_dist_kernel(**ops), rerank_dist_plain(**ops))


@pytest.mark.parametrize("m,K", [(16, 256), (128, 256), (8, 64)])
def test_adc_scan_above_max_c_matches_plain(cuda, m, K):
    """C = 1,500 through the sums-out entry: PQ tables in shared memory,
    int8-sized tables read through the caches, a byte-path width."""
    from repro_torch.kernels.adc_scan import (MAX_C, adc_scan,
                                              adc_scan_plain, adc_sums_kernel,
                                              adc_sums_plain)

    rng = np.random.default_rng(m)
    codes = torch.as_tensor(rng.integers(0, K, (3001, m)).astype(np.uint8))
    luts = torch.as_tensor(rng.integers(0, 7, (9, m, K)).astype(np.float32))
    codes, luts = codes.to(cuda), luts.to(cuda)
    luts = luts + torch.rand(luts.shape, device=cuda)
    before = adc_sums_kernel.launches
    gd, gi = adc_scan(codes, luts, k=1500, use_kernel=True)
    assert adc_sums_kernel.launches == before + 1 and 1500 > MAX_C
    wd, wi = adc_scan_plain(codes, luts, k=1500)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)
    assert torch.equal(adc_sums_kernel(codes, luts),
                       adc_sums_plain(codes, luts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["unsorted", "sorted_runs", "empty_bags"])
def test_embedding_bag_kernel_matches_plain(cuda, dtype, case):
    from repro_torch.kernels.embedbag import (bag_runs, embedding_bag,
                                              embedding_bag_kernel,
                                              embedding_bag_plain)

    rng = np.random.default_rng(3)
    V, D, N, B = 500, 200, 3000, 97
    table = torch.as_tensor(rng.standard_normal((V, D)).astype(np.float32))
    table = table.to(device=cuda, dtype=dtype)
    idx = rng.integers(0, V, N)
    bags = rng.integers(0, B, N)
    if case == "empty_bags":
        bags = bags % 40 * 2                      # odd bags stay empty
    w = rng.random(N).astype(np.float32)
    sort = case == "sorted_runs"
    if sort:
        bags = np.array([0, 1, 0] * (N // 3))     # the last run wins
    before = embedding_bag_kernel.launches
    got = embedding_bag(table, idx, bags, w, n_bags=B, assume_sorted=sort)
    assert embedding_bag_kernel.launches == before + 1
    assert got.dtype == dtype
    t = torch.as_tensor
    bt = t(bags, dtype=torch.int32, device=cuda)
    order = torch.arange(N, device=cuda) if sort \
        else torch.sort(bt, stable=True).indices
    want = embedding_bag_plain(t(idx, dtype=torch.int32, device=cuda)[order],
                               t(w, device=cuda)[order], table,
                               bag_runs(bt[order], n_bags=B), n_bags=B)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,bs,KV,G,dh", [(257, 64, 2, 4, 32),
                                          (1000, 512, 3, 3, 128),
                                          (64, 512, 1, 8, 64)])
def test_decode_attention_kernel_matches_plain(cuda, dtype, S, bs, KV, G, dh):
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_kernel,
                                                 decode_attention_plain)

    rng = np.random.default_rng(S)
    B = 5
    q = torch.as_tensor(rng.standard_normal((B, KV * G, dh)).astype(
        np.float32)).to(device=cuda, dtype=dtype)
    k = torch.as_tensor(rng.standard_normal((B, S, KV, dh)).astype(
        np.float32)).to(device=cuda, dtype=dtype)
    v = torch.as_tensor(rng.standard_normal((B, S, KV, dh)).astype(
        np.float32)).to(device=cuda, dtype=dtype)
    lengths = torch.tensor([0, 1, S // 2, S, S + 7], dtype=torch.int32,
                           device=cuda)
    before = decode_attention_kernel.launches
    got = decode_attention(q, k, v, lengths, bs=bs)
    assert decode_attention_kernel.launches == before + 1
    want = decode_attention_plain(q, k, v, lengths, bs=min(bs, S))
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("entry", ["distance_matrix", "hamming_dist",
                                   "adc_sums"])
def test_distances_out_entries_take_more_queries_than_one_grid(cuda, entry):
    """grid.y holds at most 65,535 query tiles: the hamming and ADC
    launchers slice the queries, and kernel 5 numbers its tiles on a 1-D
    grid, so any count of queries gives the plain version's answer."""
    from repro_torch.kernels.adc_scan import adc_sums_kernel, adc_sums_plain
    from repro_torch.kernels.distance import (distance_matrix_kernel,
                                              distance_matrix_plain)
    from repro_torch.kernels.distance.distance import norm_operand
    from repro_torch.kernels.hamming import (hamming_dist_kernel,
                                             hamming_dist_plain)

    rng = np.random.default_rng(9)
    if entry == "distance_matrix":
        Q, X = _ints(rng, (65535 * 64 + 3, 4)).to(cuda), \
            _ints(rng, (5, 4)).to(cuda)
        qsq, xsq = norm_operand(Q, "l2sq"), norm_operand(X, "l2sq")
        got = distance_matrix_kernel(Q, X, qsq, xsq, mode="l2sq")
        want = distance_matrix_plain(Q, X, qsq, xsq, mode="l2sq")
    elif entry == "hamming_dist":
        X = torch.randint(-2**31, 2**31 - 1, (300, 1), dtype=torch.int32,
                          device=cuda)
        Q = torch.randint(-2**31, 2**31 - 1, (65535 * 8 + 5, 1),
                          dtype=torch.int32, device=cuda)
        got = hamming_dist_kernel(Q, X, 290)
        want = hamming_dist_plain(Q, X, 290)
    else:
        codes = torch.randint(0, 4, (40, 2), dtype=torch.uint8, device=cuda)
        luts = torch.rand((65535 * 8 + 3, 2, 4), device=cuda)
        got = adc_sums_kernel(codes, luts)
        want = adc_sums_plain(codes, luts)
    assert torch.equal(got, want)


# ------------------------------- kernel 5's 128 x 128 tile, edges and grid
@pytest.mark.parametrize("d", [1, 3, 8, 37, 129])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 5003])
@pytest.mark.parametrize("nq", [1, 127, 128, 129, 5003])
def test_distance_matrix_kernel_ragged_tiles(cuda, nq, n, d):
    """Every edge of the tile (rows, columns, the 8-wide chunk of d, d % 4)
    on integer-valued inputs, where every fp32 operation is exact: the
    kernel equals its plain version bit for bit."""
    from repro_torch.kernels.distance import (distance_matrix_kernel,
                                              distance_matrix_plain)
    from repro_torch.kernels.distance.distance import norm_operand

    rng = np.random.default_rng(nq * 7 + n * 3 + d)
    Q, X = _ints(rng, (nq, d)).to(cuda), _ints(rng, (n, d)).to(cuda)
    for mode in ("l2sq", "ip", "cos"):
        qsq, xsq = norm_operand(Q, mode), norm_operand(X, mode)
        got = distance_matrix_kernel(Q, X, qsq, xsq, mode=mode)
        want = distance_matrix_plain(Q, X, qsq, xsq, mode=mode)
        assert torch.equal(got, want), mode


@pytest.mark.parametrize("n", [1001, 1002, 1003, 1004])
def test_distance_matrix_kernel_scalar_and_vector_stores(cuda, n):
    """n % 4 != 0 takes the scalar stores everywhere; n % 4 == 0 the
    16-byte stores; both agree with the plain version (gaussian inputs)."""
    from repro_torch.kernels.distance import (distance_matrix_kernel,
                                              distance_matrix_plain)
    from repro_torch.kernels.distance.distance import norm_operand

    rng = np.random.default_rng(n)
    Q = torch.as_tensor(rng.standard_normal((300, 64)).astype(np.float32))
    X = torch.as_tensor(rng.standard_normal((n, 64)).astype(np.float32))
    Q, X = Q.to(cuda), X.to(cuda)
    qsq, xsq = norm_operand(Q, "l2sq"), norm_operand(X, "l2sq")
    got = distance_matrix_kernel(Q, X, qsq, xsq, mode="l2sq")
    want = distance_matrix_plain(Q, X, qsq, xsq, mode="l2sq")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_distance_matrix_kernel_unaligned_operands(cuda):
    """Operands whose base is not 16-byte aligned (d % 4 == 0) take the
    scalar loads and give the same bits as aligned copies."""
    from repro_torch.kernels.distance import distance_matrix_kernel
    from repro_torch.kernels.distance.distance import norm_operand

    rng = np.random.default_rng(11)
    nq, n, d = 200, 700, 36
    Qa = torch.as_tensor(rng.standard_normal((nq, d)).astype(np.float32))
    Xa = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32))
    Qa, Xa = Qa.to(cuda), Xa.to(cuda)
    Qu = torch.empty(nq * d + 1, device=cuda)[1:].view(nq, d)
    Xu = torch.empty(n * d + 1, device=cuda)[1:].view(n, d)
    Qu.copy_(Qa)
    Xu.copy_(Xa)
    assert Qu.data_ptr() % 16 and Xu.data_ptr() % 16
    qsq, xsq = norm_operand(Qa, "l2sq"), norm_operand(Xa, "l2sq")
    a = distance_matrix_kernel(Qa, Xa, qsq, xsq, mode="l2sq")
    b = distance_matrix_kernel(Qu, Xu, qsq, xsq, mode="l2sq")
    assert torch.equal(a, b)


def test_distance_matrix_kernel_past_65535_tiles(cuda):
    """32,769 query tiles x 2 corpus tiles = 65,538 blocks on the 1-D grid
    (the old grid.y held 65,535 tiles of one axis)."""
    from repro_torch.kernels.distance import (distance_matrix_kernel,
                                              distance_matrix_plain)
    from repro_torch.kernels.distance.distance import norm_operand

    rng = np.random.default_rng(12)
    nq, n, d = 128 * 32768 + 1, 129, 4
    Q, X = _ints(rng, (nq, d)).to(cuda), _ints(rng, (n, d)).to(cuda)
    qsq, xsq = norm_operand(Q, "l2sq"), norm_operand(X, "l2sq")
    got = distance_matrix_kernel(Q, X, qsq, xsq, mode="l2sq")
    want = distance_matrix_plain(Q, X, qsq, xsq, mode="l2sq")
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["l2sq", "ip", "cos"])
@pytest.mark.parametrize("nq,n,d", [(129, 5003, 37), (127, 5003, 129)])
def test_distance_route_equals_stream_kernel_bitwise_ragged(cuda, mode, nq,
                                                            n, d):
    """At k = 256, at shapes ragged against both kernels' tiles and chunks,
    with 10 % of the rows masked by +inf: kernel 1 and the route through
    kernel 5 agree bit for bit."""
    from repro_torch.kernels.distance_topk import stream_topk_kernel
    from repro_torch.kernels.distance.distance import norm_operand
    from repro_torch.kernels.distance_topk.ops import distances_route

    rng = np.random.default_rng(nq + d)
    Q = torch.as_tensor(rng.standard_normal((nq, d)).astype(np.float32))
    X = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32))
    Q, X = Q.to(cuda), X.to(cuda)
    if mode == "cos":
        Q, X = Q / Q.norm(dim=1, keepdim=True), X / X.norm(dim=1, keepdim=True)
    qsq, xsq = norm_operand(Q, mode), norm_operand(X, mode)
    xsq[torch.as_tensor(rng.random(n) < 0.1).to(cuda)] = float("inf")
    a = stream_topk_kernel(Q, X, qsq, xsq, mode=mode, k=256)
    b = distances_route(Q, X, qsq, xsq, mode=mode, k=256)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ------------------------------------------------- kernel 7's lifted limits
@pytest.mark.parametrize("B,KV,G,dh", [(65537, 1, 2, 8), (3, 1, 17, 128),
                                       (2, 2, 40, 64)])
def test_decode_attention_beyond_one_launch(cuda, B, KV, G, dh):
    """B past grid.y's 65,535 rows (the launcher slices the batch), and
    G * dh past 2,048 outputs per block (the wrapper launches groups of
    query heads): the plain version's answer within 1e-5."""
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_kernel,
                                                 decode_attention_plain)
    from repro_torch.kernels.decode_attn.decode_attn import heads_per_launch

    rng = np.random.default_rng(B + G)
    S, bs = 40, 16
    q = torch.as_tensor(rng.standard_normal((B, KV * G, dh)).astype(
        np.float32)).to(cuda)
    k = torch.as_tensor(rng.standard_normal((B, S, KV, dh)).astype(
        np.float32)).to(cuda)
    v = torch.as_tensor(rng.standard_normal((B, S, KV, dh)).astype(
        np.float32)).to(cuda)
    lengths = torch.as_tensor(rng.integers(0, S + 3, B).astype(np.int32)).to(
        cuda)
    g = heads_per_launch(G, dh, bs)
    before = decode_attention_kernel.launches
    got = decode_attention(q, k, v, lengths, bs=bs)
    assert decode_attention_kernel.launches == before + -(-G // g)
    want = decode_attention_plain(q, k, v, lengths, bs=bs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------ kernel 7's split over the cache
def _decode_operands(rng, B, KV, G, S, dh, dtype, cuda):
    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32)).to(device=cuda, dtype=dtype)
    return t((B, KV * G, dh)), t((B, S, KV, dh)), t((B, S, KV, dh))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", ["one", "two", "three", "every", "auto"])
def test_decode_attention_partitions_match_plain(cuda, dtype, split):
    """S = 1000 at bs = 64 is 16 blocks: P = 1, P = 2 with a shorter last
    partition (9 + 7 blocks), P = 3 (6 + 6 + 4), P = n_blocks, and the
    wrapper's own choice; lengths 0 / 1 / mid / S / S + 7, so partitions
    lie wholly past a length.  Within 1e-5 (fp32) or one bf16 ulp of the
    plain version at the same partitions; one launch (pair) each."""
    from repro_torch.kernels.decode_attn import (decode_attention_kernel,
                                                 decode_attention_plain)
    from repro_torch.kernels.decode_attn.decode_attn import kernel_partitions

    rng = np.random.default_rng(1000)
    B, KV, G, S, dh, bs = 5, 3, 4, 1000, 64, 64
    q, k, v = _decode_operands(rng, B, KV, G, S, dh, dtype, cuda)
    lengths = torch.tensor([0, 1, S // 2, S, S + 7], dtype=torch.int32,
                           device=cuda)
    part_blocks = {"one": 16, "two": 9, "three": 6, "every": 1,
                   "auto": None}[split]
    before = decode_attention_kernel.launches
    got = decode_attention_kernel(q, k, v, lengths, bs=bs,
                                  part_blocks=part_blocks)
    assert decode_attention_kernel.launches == before + 1
    if part_blocks is None:
        part_blocks, P = kernel_partitions(q, k, bs)
        assert P > 1                     # 15 (kv, b) pairs fill no card
    want = decode_attention_plain(q, k, v, lengths, bs=bs,
                                  part_blocks=part_blocks)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("B,KV,G,dh", [(65537, 1, 2, 8), (3, 1, 17, 128),
                                       (2, 2, 40, 64)])
def test_decode_attention_partitions_beyond_one_launch(cuda, B, KV, G, dh):
    """P = 3 partitions of one block with the batch sliced past grid.y's
    65,535 rows, and with G * dh past one block (groups of query heads,
    one pair each): the plain version's answer at the same partitions."""
    from repro_torch.kernels.decode_attn import (decode_attention_kernel,
                                                 decode_attention_plain)
    from repro_torch.kernels.decode_attn.decode_attn import heads_per_launch

    rng = np.random.default_rng(B + G + 1)
    S, bs = 40, 16
    q, k, v = _decode_operands(rng, B, KV, G, S, dh, torch.float32, cuda)
    lengths = torch.as_tensor(rng.integers(0, S + 3, B).astype(np.int32)).to(
        cuda)
    before = decode_attention_kernel.launches
    got = decode_attention_kernel(q, k, v, lengths, bs=bs, part_blocks=1)
    assert decode_attention_kernel.launches == \
        before + -(-G // heads_per_launch(G, dh, bs))
    want = decode_attention_plain(q, k, v, lengths, bs=bs, part_blocks=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_decode_attention_refuses_partitions_out_of_range(cuda):
    from repro_torch.kernels.decode_attn import decode_attention_kernel

    rng = np.random.default_rng(3)
    q, k, v = _decode_operands(rng, 2, 1, 2, 40, 8, torch.float32, cuda)
    lengths = torch.full((2,), 40, dtype=torch.int32, device=cuda)
    before = decode_attention_kernel.launches
    for part_blocks in (0, 4):                        # 3 blocks of 16
        with pytest.raises(ValueError, match="part_blocks"):
            decode_attention_kernel(q, k, v, lengths, bs=16,
                                    part_blocks=part_blocks)
    assert decode_attention_kernel.launches == before


# ------------------------- kernel 1 on kernel 5's tile: variants and plan
def _off16(t):
    """A copy of ``t`` whose base lies 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _stream_case(rng, cuda, nq, n, d, mode):
    from repro_torch.kernels.distance.distance import norm_operand

    Q, X = _ints(rng, (nq, d)).to(cuda), _ints(rng, (n, d)).to(cuda)
    qsq, xsq = norm_operand(Q, mode), norm_operand(X, mode)
    xsq[torch.as_tensor(rng.random(n) < 0.1).to(cuda)] = float("inf")
    return Q, X, qsq, xsq


@pytest.mark.parametrize("mode", ["l2sq", "ip", "cos"])
@pytest.mark.parametrize("k", [1, 10, 78, 79, 100, 255, 256])
def test_stream_topk_kernel_variants_ragged(cuda, mode, k):
    """Both variants (128 query rows up to k = 78, 64 from k = 79 or at
    nq <= 64) at ragged nq, n and d, d % 4 != 0, and operands whose base is
    not 16-byte aligned (scalar loads), 10 % of the rows masked: bit for
    bit the plain version on integer-valued inputs."""
    from repro_torch.kernels.distance_topk import (stream_topk_kernel,
                                                   stream_topk_plain)

    rng = np.random.default_rng(1000 + k)
    for nq, n, d, off in [(131, 5003, 37, None), (65, 3001, 64, "X"),
                          (64, 2000, 129, "Q"), (1, 4000, 20, None),
                          (200, 129, 8, None)]:
        Q, X, qsq, xsq = _stream_case(rng, cuda, nq, n, d, mode)
        if off == "X":
            X = _off16(X)
        elif off == "Q":
            Q = _off16(Q)
        kk = min(k, n)
        gd, gi = stream_topk_kernel(Q, X, qsq, xsq, mode=mode, k=kk)
        wd, wi = stream_topk_plain(Q, X, qsq, xsq, mode=mode, k=kk, bn=1000)
        assert torch.equal(gd, wd), (nq, n, d)
        assert torch.equal(gi, wi), (nq, n, d)


@pytest.mark.parametrize("nq,k", [(1, 10), (70, 10), (1, 256), (64, 256)])
def test_stream_topk_kernel_at_max_splits(cuda, nq, k):
    """A shape whose plan takes ``MAX_SPLITS`` corpus ranges (one query
    tile, 256 corpus tiles, fewer blocks than SMs): 128 lists merged per
    query."""
    from repro_torch.kernels.distance_topk import (stream_topk_kernel,
                                                   stream_topk_plain)
    from repro_torch.kernels.distance_topk.distance_topk import (MAX_SPLITS,
                                                                 kernel_plan)

    rng = np.random.default_rng(nq + k)
    Q, X, qsq, xsq = _stream_case(rng, cuda, nq, 256 * 128, 16, "l2sq")
    assert kernel_plan(Q, X, k, "l2sq").splits == MAX_SPLITS
    gd, gi = stream_topk_kernel(Q, X, qsq, xsq, mode="l2sq", k=k)
    wd, wi = stream_topk_plain(Q, X, qsq, xsq, mode="l2sq", k=k)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)


@pytest.mark.parametrize("metric", ["euclidean", "angular", "ip"])
@pytest.mark.parametrize("k", [10, 100])
def test_stream_topk_valid_mask_on_the_kernel(cuda, metric, k):
    """Rows masked through ``valid`` never come back, and the rest equal
    the plain version with those rows at +inf."""
    from repro_torch.kernels.distance_topk import (stream_topk,
                                                   stream_topk_plain)
    from repro_torch.kernels.distance_topk.ops import _METRIC_TO_MODE
    from repro_torch.kernels.distance.distance import norm_operand

    mode = _METRIC_TO_MODE[metric]
    rng = np.random.default_rng(k)
    Q, X = _ints(rng, (150, 24)).to(cuda), _ints(rng, (3000, 24)).to(cuda)
    valid = torch.as_tensor(rng.random(3000) < 0.3).to(cuda)
    gd, gi = stream_topk(Q, X, k=k, metric=metric, valid=valid)
    xsq = norm_operand(X, mode)
    xsq[~valid] = float("inf")
    wd, wi = stream_topk_plain(Q, X, norm_operand(Q, mode), xsq, mode=mode,
                               k=k)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)
    assert bool(valid[gi.long()].all())


@pytest.mark.parametrize("mode", ["l2sq", "ip", "cos"])
@pytest.mark.parametrize("k", [10, 100, 256])
def test_stream_topk_kernel_identical_rows(cuda, mode, k):
    """Every corpus row the same: every output of a block's first tile
    survives, so the buffers overflow and the rounds run; all distances
    tie, so the ids come out ascending, 0..k-1."""
    from repro_torch.kernels.distance_topk import (stream_topk_kernel,
                                                   stream_topk_plain)
    from repro_torch.kernels.distance.distance import norm_operand

    rng = np.random.default_rng(k)
    Q = _ints(rng, (130, 33)).to(cuda)
    X = _ints(rng, (1, 33)).to(cuda).expand(3000, -1).contiguous()
    qsq, xsq = norm_operand(Q, mode), norm_operand(X, mode)
    gd, gi = stream_topk_kernel(Q, X, qsq, xsq, mode=mode, k=k)
    wd, wi = stream_topk_plain(Q, X, qsq, xsq, mode=mode, k=k)
    assert torch.equal(gd, wd)
    ids = torch.arange(k, dtype=torch.int32, device=cuda).expand(130, -1)
    assert torch.equal(gi, ids) and torch.equal(wi, ids)


def test_stream_topk_plan_matches_the_kernel(cuda):
    """The plan's shared bytes are the kernel's at every k and variant, and
    the variant the plan takes is resident two blocks per SM where it has
    128 query rows."""
    from repro_torch.kernels.distance_topk.distance_topk import (
        ROWS, _lib, blocks_per_sm, query_rows, smem_bytes)

    lib = _lib()
    for k in range(1, 257):
        for rows in ROWS:
            assert lib.stream_topk_smem_bytes(rows, k) == smem_bytes(rows, k)
        rows = query_rows(10_000, k)
        for mode in ("l2sq", "ip", "cos"):
            per_sm = blocks_per_sm(rows, k, True, mode)
            assert per_sm >= 1 and blocks_per_sm(rows, k, False, mode) >= 1
            if rows == 128:
                assert per_sm == 2, (k, mode)


def test_every_k_up_to_max_k_launches_the_stream_kernel(cuda):
    """k = 1..256 through the public op: one launch of kernel 1 each, none
    of the distances-out route, and the plain version's answer."""
    from repro_torch.kernels.distance import distance_matrix_kernel
    from repro_torch.kernels.distance_topk import (stream_topk,
                                                   stream_topk_kernel,
                                                   stream_topk_plain)
    from repro_torch.kernels.distance.distance import norm_operand

    rng = np.random.default_rng(256)
    Q, X = _ints(rng, (70, 12)).to(cuda), _ints(rng, (400, 12)).to(cuda)
    qsq, xsq = norm_operand(Q, "l2sq"), norm_operand(X, "l2sq")
    routes = distance_matrix_kernel.launches
    for k in range(1, 257):
        before = stream_topk_kernel.launches
        gd, gi = stream_topk(Q, X, k=k)
        assert stream_topk_kernel.launches == before + 1
        wd, wi = stream_topk_plain(Q, X, qsq, xsq, mode="l2sq", k=k)
        assert torch.equal(gd, wd) and torch.equal(gi, wi), k
    assert distance_matrix_kernel.launches == routes


# ----------------------------- kernel 2: the generic entry and the list entry
def _list_layout(rng, n, d, n_lists, gauss, scale=1.0):
    """A cluster-major corpus of n rows in n_lists lists (one empty), its
    starts and sizes: N(0, scale^2) rows, or integer-valued ones."""
    X = torch.as_tensor((scale * rng.standard_normal((n, d)))
                        .astype(np.float32)) if gauss else _ints(rng, (n, d))
    sizes = torch.as_tensor(rng.multinomial(n, np.ones(n_lists) / n_lists)
                            .astype(np.int32))
    sizes[1] += sizes[0]
    sizes[0] = 0
    starts = (torch.cumsum(sizes, 0) - sizes).to(torch.int32)
    return X, starts, sizes


def _gate(got, want_k1, k, tol=2e-3):
    """chip_smoke.py's gate: distances within ``tol`` of the plain
    version's, ids equal outside near ties (neighbouring plain distances,
    the (k+1)-th included, within ``tol``)."""
    gd, gi = got
    wd, wi = want_k1[0][:, :k + 1], want_k1[1][:, :k + 1]
    fin = torch.isfinite(wd[:, :k])
    assert torch.equal(fin, torch.isfinite(gd))
    assert float((gd - wd[:, :k]).abs()[fin].max()) <= tol
    bad = gi != wi[:, :k]
    gap = (wd[:, 1:] - wd[:, :-1]).abs() <= tol
    near = torch.zeros_like(bad)
    near[:, 1:] |= gap[:, :k - 1]
    near |= gap[:, :k]
    assert int((bad & ~near).sum()) == 0


def _both_entries(cuda, mode, k, seed, *, b=301, n=6007, d=24, n_lists=37,
                  P=7, n_probes=5, scan=None, live=True, id_map=True,
                  scale=1.0):
    from repro_torch.kernels.rerank_topk import lists
    from repro_torch.kernels.rerank_topk.ops import kernel_operands

    rng = np.random.default_rng(seed)
    X, starts, sizes = _list_layout(rng, n, d, n_lists, gauss=True,
                                    scale=scale)
    Q = torch.as_tensor((scale * rng.standard_normal((b, d)))
                        .astype(np.float32))
    if mode == "cos":
        X = X / X.norm(dim=1, keepdim=True)
        Q = Q / Q.norm(dim=1, keepdim=True)
    # half the queries probe list 3 first: a list of many queries
    probes = torch.as_tensor(np.stack([
        rng.permutation(n_lists)[:P] if q % 2 else
        np.concatenate([[3], rng.permutation(np.delete(
            np.arange(n_lists), 3))[:P - 1]]) for q in range(b)]))
    row_ids = torch.as_tensor(rng.permutation(n).astype(np.int32))
    if id_map:
        row_ids = row_ids // 2               # every id twice
    row_live = torch.as_tensor(rng.random(n) < 0.9) if live else None
    X, Q, probes, starts, sizes, row_ids = (
        t.to(cuda) for t in (X, Q, probes, starts, sizes, row_ids))
    if row_live is not None:
        row_live = row_live.to(cuda)
    xsq = (X * X).sum(1)
    qsq = (Q * Q).sum(1) if mode == "l2sq" else torch.zeros(b, device=cuda)
    M = int(sizes.max())
    n_p = torch.tensor(n_probes, dtype=torch.int32, device=cuda)
    got = lists.rerank_lists_kernel(
        Q, qsq, X, xsq if mode == "l2sq" else None, probes, starts, sizes,
        row_ids, M=M, mode=mode, k=k, n_probes=n_p, scan=scan,
        row_live=None if row_live is None else row_live.to(torch.uint8))
    cand, valid = lists.list_window(probes, starts, sizes, M, n,
                                    n_probes=n_p, scan=scan,
                                    row_live=row_live)
    metric = "euclidean" if mode == "l2sq" else "angular"
    ops = kernel_operands(Q, X, qsq[:, None] if mode == "l2sq" else None,
                          xsq, cand, ~valid, row_ids, metric, k)
    return got, ops


@pytest.mark.parametrize("mode", ["l2sq", "cos"])
@pytest.mark.parametrize("k", [1, 10, 100, 256])
def test_list_entry_equals_generic_entry_bitwise(cuda, mode, k):
    """The two entries compute <q, x> the same way, so on the window of
    the probed lists they agree bit for bit; both meet the plain gate."""
    from repro_torch.kernels.rerank_topk import (rerank_lists_kernel,
                                                 rerank_topk_kernel,
                                                 rerank_topk_plain)

    before = rerank_lists_kernel.launches
    got, ops = _both_entries(cuda, mode, k, seed=k)
    assert rerank_lists_kernel.launches == before + 1
    generic = rerank_topk_kernel(**ops)
    torch.cuda.synchronize()
    assert torch.equal(got[0], generic[0]) and torch.equal(got[1], generic[1])
    want = rerank_topk_plain(**dict(ops, k=k + 1))
    _gate(got, want, k)
    _gate(generic, want, k)
    for row in got[1].tolist():
        kept = [i for i in row if i >= 0]
        assert len(set(kept)) == len(kept)


@pytest.mark.parametrize("mode", ["l2sq", "cos"])
@pytest.mark.parametrize("b,n_probes,scan", [(1, 7, None), (2, 3, 40),
                                             (777, 0, None), (400, 9, 1)])
def test_list_entry_edges_equal_generic_entry(cuda, mode, b, n_probes, scan):
    """One query, no live probe slot, n_probes past P, a scan budget of
    one row; no live mask or id map."""
    from repro_torch.kernels.rerank_topk import rerank_topk_kernel

    got, ops = _both_entries(cuda, mode, 10, seed=b, b=b, n_probes=n_probes,
                             scan=None if scan is None else
                             torch.tensor(scan, device=cuda), live=False,
                             id_map=False)
    generic = rerank_topk_kernel(**ops)
    assert torch.equal(got[0], generic[0]) and torch.equal(got[1], generic[1])
    if n_probes == 0:
        assert bool((got[1] == -1).all())


@pytest.mark.parametrize("mode", ["l2sq", "cos"])
@pytest.mark.parametrize("k", [10, 256])
def test_both_entries_within_the_exact_bound(cuda, mode, k):
    """At d = 128 on N(0, 9) rows (squared norms near 1,150), each
    entry's distances lie within EXACT_REL of the exact value, the cross
    term summed in fp64, relative to that term's weight."""
    from repro_torch.kernels.rerank_topk import (EXACT_REL, err_vs_exact,
                                                 rerank_topk_kernel)

    got, ops = _both_entries(cuda, mode, k, seed=128 + k, d=128, scale=3.0,
                             id_map=False)
    generic = rerank_topk_kernel(**ops)
    for out in (got, generic):
        assert bool((out[1][:, :k] >= 0).any())
        err, rel = err_vs_exact(out, **ops)
        assert rel <= EXACT_REL, (err, rel)


def test_list_entry_plan_matches_the_kernel(cuda):
    from repro_torch.kernels.rerank_topk.lists import (_lib, blocks_per_sm,
                                                       smem_bytes)

    lib = _lib()
    for kp in range(1, 257):
        assert lib.rerank_lists_smem_bytes(kp) == smem_bytes(kp)
    assert lib.rerank_lists_smem_bytes(257) == -1
    assert blocks_per_sm(10, True, "l2sq") >= 2
    assert blocks_per_sm(256, True, "l2sq") >= 1


def test_ivf_search_takes_the_list_entry(cuda):
    from repro_torch.ann import ivf
    from repro_torch.kernels.rerank_topk import (rerank_lists_kernel,
                                                 rerank_topk_kernel)

    rng = np.random.default_rng(5)
    X = rng.standard_normal((4000, 32)).astype(np.float32)
    st = ivf.build(X, n_clusters=40, rerank_kernel=True)
    lists_before = rerank_lists_kernel.launches
    topk_before = rerank_topk_kernel.launches
    d, i = ivf.search(st, X[:50], k=5, n_probes=torch.tensor(3),
                      max_probes=8)
    assert rerank_lists_kernel.launches == lists_before + 1
    assert rerank_topk_kernel.launches == topk_before
    assert (i[:, 0].cpu().numpy() == np.arange(50)).all()
    cpu = ivf.search(ivf.IndexState(st.algo, st.metric,
                                    {k: v.cpu() for k, v in st.arrays.items()},
                                    st.static),
                     X[:50], k=5, n_probes=3, max_probes=8)
    torch.testing.assert_close(d.cpu(), cpu[0], rtol=1e-5, atol=1e-4)


def test_kmeans_and_pq_training_repeat_bit_for_bit(cuda):
    """Two builds of one corpus on the card give the same centers,
    assignment and PQ codes bit for bit (each cluster summed in index
    order), and the centers equal the CPU's."""
    from repro_torch.ann.kmeans import kmeans
    from repro_torch.quant import train_codec

    X = np.random.default_rng(3).standard_normal((20000, 32)) \
        .astype(np.float32)
    a = kmeans(X, 64, device=cuda)
    b = kmeans(X, 64, device=cuda)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    c = kmeans(X, 64, device="cpu")
    np.testing.assert_array_equal(a[0], c[0])
    np.testing.assert_array_equal(a[1], c[1])
    pq = {"pq": {"m": 8, "bits": 8}}
    first, _ = train_codec(X, pq, metric="euclidean", device=cuda)
    again, _ = train_codec(X, pq, metric="euclidean", device=cuda)
    assert torch.equal(first["codes"], again["codes"])
    assert torch.equal(first["codebooks"], again["codebooks"])


def _state_on(state, device):
    """A (mutable) IndexState with every tensor moved to ``device``; the
    host-side counters stay where they are."""
    from repro_torch.ann.functional import IndexState

    def move(name, a):
        if isinstance(a, IndexState):
            return _state_on(a, device)
        if name in ("count", "next_id") or not torch.is_tensor(a):
            return a
        return a.to(device)

    return IndexState(state.algo, state.metric,
                      {k: move(k, v) for k, v in state.arrays.items()},
                      state.static)


def test_mutable_ivf_list_entry_with_row_live_matches_plain(cuda):
    """MutableIVF (``rerank_kernel``) after inserts and deletes: its main
    search is kernel 2's list entry with the tombstones as ``row_live``,
    and so is its delta scan (the filled slots as one list); on
    integer-valued rows it equals the same state's plain path on the CPU
    bit for bit, ids and distances."""
    from repro_torch import mutate
    from repro_torch.kernels.rerank_topk import rerank_lists_kernel

    rng = np.random.default_rng(23)
    X = rng.integers(-4, 5, (3000, 24)).astype(np.float32)
    Q = rng.integers(-4, 5, (70, 24)).astype(np.float32)
    st = mutate.IVF_SPEC.build(X[:2800], n_clusters=30, rerank_kernel=True,
                               delta_capacity=256)
    st, ids = mutate.insert(st, X[2800:])
    st = mutate.delete(st, np.concatenate([np.arange(0, 2800, 7),
                                           ids[::5]]))
    before = rerank_lists_kernel.launches
    for n_probes in (1, 6, 30):
        d, i = mutate.IVF_SPEC.search(st, Q, k=10, n_probes=n_probes)
        wd, wi = mutate.IVF_SPEC.search(_state_on(st, "cpu"), Q, k=10,
                                        n_probes=n_probes)
        assert torch.equal(i.cpu(), wi)
        torch.testing.assert_close(d.cpu(), wd, rtol=0, atol=0)
    assert rerank_lists_kernel.launches == before + 6


@pytest.mark.parametrize("metric,d", [("euclidean", 18), ("euclidean", 100),
                                      ("angular", 128), ("angular", 18),
                                      ("hamming", 4), ("hamming", 8),
                                      ("hamming", 3), ("euclidean", 300)])
@pytest.mark.parametrize("k", [1, 10, 256])
def test_generic_entry_shapes_match_plain(cuda, metric, d, k):
    """Repeated ids, C not a multiple of 32, rows of d words (16-byte and
    4-byte staging, chunks of d past 128 words), and an all-masked query
    row; bit for bit on integer-valued inputs."""
    from repro_torch.bits import words_to_tensor
    from repro_torch.kernels.rerank_topk import (rerank_dist_kernel,
                                                 rerank_dist_plain,
                                                 rerank_topk_kernel,
                                                 rerank_topk_plain)
    from repro_torch.kernels.rerank_topk.ops import kernel_operands

    rng = np.random.default_rng(d + k)
    b, C, n = 45, 1001, 700
    if metric == "hamming":
        X = words_to_tensor(rng.integers(0, 2**32, (n, d), dtype=np.uint64)
                            .astype(np.uint32), cuda)
        Q = X[torch.as_tensor(rng.integers(0, n, b)).to(cuda)] ^ 3
        qsq = xsq = None
    else:
        X, Q = _ints(rng, (n, d)).to(cuda), _ints(rng, (b, d)).to(cuda)
        qsq = torch.sum(Q * Q, dim=1, keepdim=True) \
            if metric == "euclidean" else None
        xsq = torch.sum(X * X, dim=1) if metric == "euclidean" else None
    cand = torch.as_tensor(rng.integers(0, n, (b, C)).astype(np.int32))
    cand[:, 500:600] = cand[:, :100]               # the same rows again
    bad = torch.as_tensor(rng.random((b, C)) < 0.5)
    bad[7] = True                                  # an all-masked row
    bad[:, 40:300] = True                          # whole groups masked
    cand, bad = cand.to(cuda), bad.to(cuda)
    row_ids = torch.as_tensor((rng.permutation(n) // 3).astype(np.int32)) \
        .to(cuda)                                  # ids repeat
    ops = kernel_operands(Q, X, qsq, xsq, cand, bad, row_ids, metric, k)
    before = rerank_topk_kernel.launches
    gd, gi = rerank_topk_kernel(**ops)
    torch.cuda.synchronize()
    assert rerank_topk_kernel.launches == before + 1
    wd, wi = rerank_topk_plain(**ops)
    assert torch.equal(gd, wd) and torch.equal(gi, wi)
    assert bool((gi[7] == -1).all())
    ops.pop("k")
    assert torch.equal(rerank_dist_kernel(**ops), rerank_dist_plain(**ops))


# ------------------------- kernel 6: every variant, spans, unaligned tables
def _embedbag_stream_case(cuda, D, dtype, seed, B=57, V=300):
    """Bags of 0, 1, 31, 33 and 100 lookups in a random order, and three
    tables of the same rows: contiguous, a view one row in, and a copy one
    element past a 16-byte boundary."""
    from repro_torch.kernels.embedbag import bag_spans

    rng = np.random.default_rng(seed)
    lens = rng.choice([0, 1, 31, 33, 100], B)
    lens[:5] = [0, 1, 31, 33, 100]
    bags = torch.as_tensor(np.repeat(np.arange(B), lens).astype(np.int32))
    N = bags.numel()
    big = torch.as_tensor(rng.standard_normal((V + 1, D)).astype(np.float32))
    big = big.to(device=cuda, dtype=dtype)
    idx = torch.as_tensor(rng.integers(0, V, N).astype(np.int32)).to(cuda)
    w = torch.as_tensor(rng.random(N).astype(np.float32)).to(cuda)
    tables = {"contiguous": big[1:].clone(), "row_view": big[1:],
              "off16": _off16(big[1:])}
    return idx, w, tables, bag_spans(bags.to(cuda), n_bags=B), B


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 10, 16, 128, 200, 256])
def test_embedding_bag_every_variant_matches_plain(cuda, dtype, D):
    """Every compiled variant (vector bytes, lanes, rows in flight) that can
    take the rows, with one bag a group and the plan's range, on each
    layout of the table: bit for bit with the plain version, the output
    in the table's type; the default plan on memory that held NaNs."""
    from repro_torch.kernels.embedbag import (embedding_bag_kernel,
                                              embedding_bag_plain)
    from repro_torch.kernels.embedbag.embedbag import (VARIANTS, DTYPES,
                                                       kernel_plan, plan)

    idx, w, tables, spans, B = _embedbag_stream_case(cuda, D, dtype, D)
    want = embedding_bag_plain(idx, w, tables["contiguous"], spans,
                               n_bags=B)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tried = set()
    for layout, table in tables.items():
        aligned = table.data_ptr() % 16 == 0
        assert aligned == (layout == "contiguous"
                           or (layout == "row_view" and D * table
                               .element_size() % 16 == 0))
        torch.full((B, D), float("nan"), dtype=dtype, device=cuda)
        got = embedding_bag_kernel(idx, w, table, spans, n_bags=B)
        assert got.dtype == dtype and torch.equal(got, want), layout
        for dt, vec, cpl, U in VARIANTS:
            if dt != DTYPES[dtype]:
                continue
            for bpg in (1, None):
                try:
                    p = plan(B, idx.numel(), D, dtype, aligned, sms, 2,
                             vec=vec, cpl=cpl, bags_per_group=bpg)
                except ValueError:      # vectors that do not divide a row
                    continue
                before = embedding_bag_kernel.launches
                got = embedding_bag_kernel(idx, w, table, spans, n_bags=B,
                                           plan=p)
                assert embedding_bag_kernel.launches == before + 1
                assert torch.equal(got, want), (layout, p)
                tried.add((vec, cpl, U))
        assert kernel_plan(idx, table, B)["vec"] in {v for v, _, _ in tried}
    assert tried


def test_embedding_bag_last_run_wins_on_the_kernel(cuda):
    from repro_torch.kernels.embedbag import (bag_runs, embedding_bag,
                                              embedding_bag_kernel,
                                              embedding_bag_plain)

    rng = np.random.default_rng(9)
    table = torch.as_tensor(rng.standard_normal((40, 64)).astype(
        np.float32)).to(cuda)
    bags = np.array([0, 0, 1, 0, 2, 2, 1, 1, 1, 0] * 7)
    idx = rng.integers(0, 40, bags.size)
    w = rng.random(bags.size).astype(np.float32)
    before = embedding_bag_kernel.launches
    got = embedding_bag(table, idx, bags, w, n_bags=4, assume_sorted=True)
    assert embedding_bag_kernel.launches == before + 1
    t = torch.as_tensor
    want = embedding_bag_plain(
        t(idx, dtype=torch.int32, device=cuda), t(w, device=cuda), table,
        bag_runs(t(bags, dtype=torch.int32, device=cuda), n_bags=4),
        n_bags=4)
    assert torch.equal(got, want) and bool((got[3] == 0).all())


def test_embedding_bag_kernel_refuses_a_plan_for_other_operands(cuda):
    from repro_torch.kernels.embedbag import embedding_bag_kernel
    from repro_torch.kernels.embedbag.embedbag import kernel_plan, plan

    idx, w, tables, spans, B = _embedbag_stream_case(cuda, 10, torch.float32,
                                                     4)
    table = tables["off16"]
    good = kernel_plan(idx, table, B)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    before = embedding_bag_kernel.launches
    for bad in (plan(B, idx.numel(), 10, torch.float32, True, sms, 2),
                dict(good, grid=good["grid"] - 1), dict(good, U=3),
                plan(100 * B, idx.numel(), 10, torch.float32, False, sms, 2,
                     bags_per_group=1)):
        with pytest.raises(ValueError, match="does not fit"):
            embedding_bag_kernel(idx, w, table, spans, n_bags=B, plan=bad)
    assert embedding_bag_kernel.launches == before


def _state_on_cpu(state):
    from repro_torch.ann.functional import IndexState

    return IndexState(state.algo, state.metric,
                      {k: v.cpu() for k, v in state.arrays.items()},
                      state.static)


@pytest.mark.parametrize("route", ["bruteforce", "ivf", "pq"])
def test_sharded_kernel_routes_match_plain(cuda, route):
    """At S = 4 each sharded kernel route equals the same search on a CPU
    copy of the state (the plain versions): kernel 1 a shard
    (ShardedBruteForce, ``use_kernel``), kernel 2's generic entry a shard
    (ShardedIVF, ``rerank_kernel``; every list probed, so the probe set
    does not hang on the coarse step's rounding), kernels 4 and 2 a shard
    (PQ, ``adc_kernel`` / ``rerank_kernel``; every row a candidate).
    Integer rows: every distance exact, ids and distances bitwise."""
    from repro_torch.ann import sharded
    from repro_torch.dist.mesh import force_device_count
    from repro_torch.kernels.adc_scan import adc_scan_kernel
    from repro_torch.kernels.distance_topk import stream_topk_kernel
    from repro_torch.kernels.rerank_topk import rerank_topk_kernel

    rng = np.random.default_rng(9)
    X = _ints(rng, (4003, 36)).numpy()
    Q = _ints(rng, (131, 36)).numpy()
    prev = force_device_count(4)
    try:
        if route == "bruteforce":
            st = sharded.bruteforce_build(X, n_shards=4, device=cuda)
            kw, counts = {"use_kernel": True}, {stream_topk_kernel: 4}
            search = sharded.bruteforce_search
        elif route == "ivf":
            st = sharded.ivf_build(X, n_clusters=16, n_shards=4,
                                   rerank_kernel=True, device=cuda)
            kw, counts = {"n_probes": 16}, {rerank_topk_kernel: 4}
            search = sharded.ivf_search
        else:
            st = sharded.bruteforce_build(
                X, n_shards=4, quantize={"pq": {"m": 6}}, adc_kernel=True,
                rerank_kernel=True, device=cuda)
            kw = {}
            counts = {adc_scan_kernel: 4, rerank_topk_kernel: 4}
            search = sharded.bruteforce_search
        before = {fn: fn.launches for fn in counts}
        gd, gi = search(st, torch.as_tensor(Q, device=cuda), k=10, **kw)
        torch.cuda.synchronize()
        assert {fn: fn.launches - before[fn] for fn in counts} == counts
        wd, wi = search(_state_on_cpu(st), Q, k=10, **kw)
        assert torch.equal(gi.cpu(), wi)
        torch.testing.assert_close(gd.cpu(), wd, rtol=0, atol=0)
    finally:
        force_device_count(prev)


LM_ARCHS = ["gemma3-27b", "phi4-mini-3.8b", "qwen1.5-32b",
            "moonshot-v1-16b-a3b", "deepseek-v2-236b"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_serve_step_on_the_card_equals_the_cpu(cuda, arch):
    """Each LM smoke config (fp32), the same weights on the card and on
    the CPU: a 32-token prefill, then 3 ``serve_step`` calls from its
    caches in a 40-slot cache (gemma3's 16-slot ring wraps); logits and
    caches within rtol = 1e-5, atol = 1e-4 (the logits reach ~60), as the
    CPU parity tests hold the port to the reference."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    cfg = get_arch(arch).make_smoke_config()
    params = T.init(0, cfg, device=cuda)
    host = T._map_leaves(lambda t: t.cpu(), params)
    toks = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 35)))
    out = {}
    for dev, p in (("cuda", params), ("cpu", host)):
        logits, pre = T.prefill_step(p, cfg, toks[:, :32].to(dev))
        caches = T.init_cache(cfg, 2, 40, device=dev)
        for run, prun in zip(caches, pre):
            for c, pc in zip(run, prun):
                c[:, :, :pc.shape[2]] = pc
        steps = [logits]
        for t in range(3):
            lg, caches = T.serve_step(p, cfg, toks[:, 32 + t:33 + t].to(dev),
                                      caches, 32 + t)
            steps.append(lg)
        out[dev] = (steps, caches)
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
    for run, wrun in zip(out["cuda"][1], out["cpu"][1]):
        for c, w in zip(run, wrun):
            torch.testing.assert_close(c.cpu(), w, rtol=1e-5, atol=1e-4)
