"""The launch plan of the streaming distance + top-k kernel
(``repro_torch.kernels.distance_topk.distance_topk.launch_plan``): a pure
function of (nq, n, k, SM count, resident blocks per SM), so it is held
here on the CPU for every k the kernel takes.  The kernel's own shared
memory count equals ``smem_bytes`` (``tests/test_torch_cuda.py``)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.distance_topk.distance_topk import (  # noqa: E402
    BN, MAX_SPLITS, ROWS, SMEM_BLOCK, SMEM_RESERVED, SMEM_SM, launch_plan,
    query_rows, smem_bytes)

KS = range(1, kernels.MAX_K + 1)
SHAPES = [(1, 1), (1, 1_000_000), (64, 5003), (65, 5003), (131, 5003),
          (4096, 1_000_000), (10_000, 1_000_000), (10_000, 200_000),
          (1000, 127), (300_000, 16_385)]


def test_every_k_fits_a_block():
    for nq in (1, 64, 65, 10_000):
        for k in KS:
            rows = query_rows(nq, k)
            assert rows in ROWS
            assert smem_bytes(rows, k) <= SMEM_BLOCK, (nq, k, rows)


def test_128_rows_only_where_two_blocks_fit_an_sm():
    for k in KS:
        two = 2 * (smem_bytes(128, k) + SMEM_RESERVED) <= SMEM_SM
        assert query_rows(10_000, k) == (128 if two else 64)
        assert query_rows(64, k) == 64
    # the lists decide it: 128 rows up to k = 78, 64 rows from k = 79
    assert query_rows(10_000, 78) == 128 and query_rows(10_000, 79) == 64


def test_smem_counts_the_lists():
    # stage buffers + norms, then per row k pairs, CAP pairs and a count
    assert smem_bytes(128, 10) - smem_bytes(128, 9) == 128 * 8
    assert smem_bytes(64, 256) - smem_bytes(64, 255) == 64 * 8
    assert smem_bytes(128, 256) > SMEM_BLOCK     # why 64 rows exist


@pytest.mark.parametrize("nq,n", SHAPES)
@pytest.mark.parametrize("sms,per_sm", [(132, 1), (132, 2), (132, 3),
                                        (8, 1)])
def test_splits_cover_the_corpus_in_whole_tiles(nq, n, sms, per_sm):
    for k in KS:
        plan = launch_plan(nq, n, k, sms, per_sm)
        assert plan.rows == query_rows(nq, k)
        assert plan.smem == smem_bytes(plan.rows, k) <= SMEM_BLOCK
        assert 1 <= plan.splits <= MAX_SPLITS
        assert plan.rows_per_split % BN == 0
        # split s covers [s * rows_per_split, min((s + 1) * ..., n)): the
        # last split ends at or past n, every split starts before n
        assert (plan.splits - 1) * plan.rows_per_split < n
        assert plan.splits * plan.rows_per_split >= n


def test_main_path_plan_fills_its_waves():
    # BruteForce's batch: 10^4 queries x 10^6 rows, k = 10, 132 SMs with
    # two blocks of 128 rows resident on each
    plan = launch_plan(10_000, 1_000_000, 10, 132, 2)
    assert plan.rows == 128
    blocks = -(-10_000 // 128) * plan.splits
    waves = -(-blocks // 264)
    assert blocks / (waves * 264) >= 0.95
    # one query: every split it can take, one block each
    one = launch_plan(1, 1_000_000, 10, 132, 2)
    assert one.rows == 64 and one.splits >= 100


def test_plan_rejects_what_the_kernel_does_not_take():
    for args in [(0, 10, 1, 132, 2), (10, 0, 1, 132, 2), (10, 10, 0, 132, 2),
                 (10, 10, kernels.MAX_K + 1, 132, 2), (10, 10, 1, 132, 0)]:
        with pytest.raises(ValueError):
            launch_plan(*args)


def test_large_k_takes_few_corpus_ranges():
    # each range inserts about k (1 + ln(m / k)) pairs per query, so at
    # large k the plan keeps the ranges few (nq = 4,096, 10^6 rows)
    small = launch_plan(4096, 1_000_000, 10, 132, 2)
    mid = launch_plan(4096, 1_000_000, 100, 132, 2)
    large = launch_plan(4096, 1_000_000, 256, 132, 1)
    assert (mid.rows, large.rows) == (64, 64)
    assert large.splits <= mid.splits <= small.splits
    assert large.splits <= 4
