"""``chip_smoke.py``'s card-against-CPU agreement of the graph family
(``agree_within_ties``): a query agrees where its two id lists are equal,
or differ only at ranks where the two ids lie at one float64 distance from
the query within ``TIE_REL`` of it.  Planted exact and near ties pass; a
swap of ids at distances further apart, or an id in the wrong place,
fails.  Runs on the CPU: the predicate is numpy only."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
K = 10
METRICS = ("euclidean", "angular")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(metric, smoke):
    """300 rows of dim 16 with row 7 a copy of row 3 (an exact tie for
    every query), queries next to row 3, and the exact top-K ids."""
    rng = np.random.default_rng(5)
    train = rng.standard_normal((300, 16)).astype(np.float32)
    train[7] = train[3]
    Q = (train[3] + 0.05 * rng.standard_normal((6, 16))).astype(np.float32)
    ids = np.stack([np.argsort(smoke.distances64(train, q, np.arange(300),
                                                 metric), kind="stable")[:K]
                    for q in Q])
    return train, Q, ids


@pytest.mark.parametrize("metric", METRICS)
def test_equal_lists_agree(smoke, metric):
    train, Q, ids = _data(metric, smoke)
    assert smoke.agree_within_ties(ids, ids.copy(), train, Q, metric).all()


@pytest.mark.parametrize("metric", METRICS)
def test_swap_at_an_exact_tie_agrees(smoke, metric):
    train, Q, ids = _data(metric, smoke)
    assert set(ids[:, :2].ravel()) == {3, 7}
    other = ids.copy()
    other[0, [0, 1]] = other[0, [1, 0]]
    assert smoke.agree_within_ties(ids, other, train, Q, metric).all()


@pytest.mark.parametrize("metric", METRICS)
def test_swap_that_is_no_near_tie_fails(smoke, metric):
    train, Q, ids = _data(metric, smoke)
    other = ids.copy()
    other[2, [2, 3]] = other[2, [3, 2]]
    d = smoke.distances64(train, Q[2], ids[2, [2, 3]], metric)
    assert abs(d[1] - d[0]) > smoke.TIE_REL * max(abs(d))
    got = smoke.agree_within_ties(ids, other, train, Q, metric)
    assert got.tolist() == [i != 2 for i in range(len(Q))]


@pytest.mark.parametrize("metric", METRICS)
def test_wrong_id_fails(smoke, metric):
    """An id outside the top-K in place of the last one: the lists differ
    at one rank, and not at a near tie."""
    train, Q, ids = _data(metric, smoke)
    far = next(i for i in range(300) if i not in ids[4])
    other = ids.copy()
    other[4, K - 1] = far
    got = smoke.agree_within_ties(ids, other, train, Q, metric)
    assert got.tolist() == [i != 4 for i in range(len(Q))]


@pytest.mark.parametrize("metric", METRICS)
def test_padding_id_fails(smoke, metric):
    train, Q, ids = _data(metric, smoke)
    other = ids.copy()
    other[1, K - 1] = -1
    got = smoke.agree_within_ties(ids, other, train, Q, metric)
    assert got.tolist() == [i != 1 for i in range(len(Q))]


@pytest.mark.parametrize("gap, agrees", [(2.0 ** -20, True),
                                         (2.0 ** -12, False)])
def test_near_tie_is_judged_by_its_relative_gap(smoke, gap, agrees):
    """Two rows at squared-l2 distances 1 and 1 + ``gap`` from the query
    (float64 data): a gap under ``TIE_REL`` is a near tie, one over it is
    not."""
    train = np.zeros((3, 4))
    train[0, 0] = 1.0
    train[1, 1] = np.sqrt(1.0 + gap)
    train[2, 2] = 3.0
    Q = np.zeros((1, 4))
    got = smoke.agree_within_ties(np.array([[0, 1]]), np.array([[1, 0]]),
                                  train, Q, "euclidean")
    assert got.tolist() == [agrees]


def test_unknown_metric_raises(smoke):
    with pytest.raises(ValueError, match="hamming"):
        smoke.distances64(np.zeros((2, 4)), np.zeros(4), np.array([0]),
                          "hamming")
