"""The port's ``pick_rerank_block`` (``repro_torch.kernels.rerank_topk.ops``)
against the JAX package's on the same arguments: the keyword-only
``itemsize`` and ``budget`` size the streaming fold's working set as the
reference's do, and positional calls keep the 4-byte, 32 MiB default.
Integers, so equal exactly."""

import pytest

pytest.importorskip("torch")

import repro.ann  # noqa: E402,F401  (the package's own import order)
from repro.kernels.rerank_topk.ops import (  # noqa: E402
    _FOLD_BUDGET as JX_BUDGET, pick_rerank_block as jx_pick)
from repro_torch.kernels.rerank_topk.ops import (  # noqa: E402
    _FOLD_BUDGET, pick_rerank_block)

SHAPES = [(1, 64, 8, 10), (512, 1 << 20, 512, 100), (256, 8192, 128, 10),
          (0, 0, 1, 1), (10_000, 1000, 128, 10), (64, 5000, 100, 256),
          (4096, 300, 96, 100)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("budget", [None, 1 << 20, 4 << 20])
@pytest.mark.parametrize("b,C,d,k", SHAPES)
def test_block_equals_the_reference(b, C, d, k, itemsize, budget):
    kw = {"itemsize": itemsize}
    if budget is not None:
        kw["budget"] = budget
    assert pick_rerank_block(b, C, d, k, **kw) == jx_pick(b, C, d, k, **kw)


@pytest.mark.parametrize("b,C,d,k", SHAPES)
def test_positional_calls_keep_the_default(b, C, d, k):
    assert _FOLD_BUDGET == JX_BUDGET
    got = pick_rerank_block(b, C, d, k)
    assert got == pick_rerank_block(b, C, d, k, itemsize=4,
                                    budget=_FOLD_BUDGET)
    assert got == jx_pick(b, C, d, k)
    with pytest.raises(TypeError):
        pick_rerank_block(b, C, d, k, 4)        # keyword-only, as upstream
