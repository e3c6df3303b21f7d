"""Streaming mutation of the port (``repro_torch.mutate``) against the JAX
package's (``repro.mutate``) and against the live-row oracle: the
scenarios of ``tests/test_mutate.py`` up to its checkpoint tests, plus
the functional contract (an older state answers as before).

The invariant: after any interleaved insert/delete stream, search ids
equal a fresh brute-force build over the live rows, selected canonically
by (distance, global id).  Rows come from small integer grids, so every
float operation is exact and ids are compared bit for bit.  Where the
reference's own test is red (``test_deleted_ids_never_appear_under_exact_
ties[angular]``, ``test_property_churn_stream_matches_oracle``), the
port is held to the oracle only; elsewhere also to the reference's ids.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import mutate as jx_mutate  # noqa: E402
from repro_torch import mutate  # noqa: E402
from repro_torch.ann import bruteforce  # noqa: E402
from repro_torch.ann.functional import (bind_search,  # noqa: E402
                                        prepare_points, prepare_queries,
                                        search_sweep_points)
from repro_torch.kernels.rerank_topk import rerank_topk  # noqa: E402

METRICS = ("euclidean", "angular", "hamming")


def _vectors(rng, m, d, metric):
    """Exact-arithmetic test rows: small-integer floats or packed uint32
    words (``tests/test_mutate.py::_vectors``)."""
    if metric == "hamming":
        return rng.integers(0, 2**31, size=(m, d),
                            dtype=np.int64).astype(np.uint32)
    return rng.integers(-8, 8, size=(m, d)).astype(np.float32)


def _spec(state, jx=False):
    mod = jx_mutate if jx else mutate
    return (mod.BRUTEFORCE_SPEC if state.algo == "MutableBruteForce"
            else mod.IVF_SPEC)


def _oracle(state, Q, k):
    """Every live row scanned by the distance of the state's main index,
    selected canonically on the global ids: a fresh BruteForce main (as
    the mutable layer builds one) for MutableBruteForce; IVF's rerank, on
    its route, over the whole live set for MutableIVF."""
    gids, rows = mutate.live_items(state)
    if state.algo == "MutableBruteForce":
        ost = bruteforce.exact_angular(
            bruteforce.build(rows, metric=state.metric, device="cpu"))
        return bruteforce.search(
            ost, Q, k=k, live=torch.ones(len(gids), dtype=torch.bool),
            id_map=torch.as_tensor(gids))
    X = torch.as_tensor(prepare_points(rows, state.metric))
    cand = torch.arange(len(gids), dtype=torch.int32)[None, :]
    return rerank_topk(
        prepare_queries(Q, state.metric, "cpu"), X,
        cand.expand(len(Q), -1), k=k, metric=state.metric,
        xsq=torch.sum(X ** 2, dim=1) if state.metric == "euclidean"
        else None, row_ids=torch.as_tensor(gids),
        use_kernel=state["main"].stat("rerank_kernel"))


def _assert_matches_oracle(state, Q, k, **knobs):
    od, oi = _oracle(state, Q, k)
    d, i = _spec(state).search(state, Q, k=k, **knobs)
    oi, i = oi.numpy(), i.numpy()
    w = oi.shape[1]
    assert np.array_equal(i[:, :w], oi), (i[:2], oi[:2])
    assert (i[:, w:] == -1).all()
    np.testing.assert_array_equal(d.numpy()[:, :w], od.numpy())


def _assert_matches_reference(state, jx_state, Q, k, **knobs):
    _, i = _spec(state).search(state, Q, k=k, **knobs)
    _, wi = _spec(jx_state, jx=True).search(jx_state, Q, k=k, **knobs)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))


def _both(fn_name, st, jst, *args, **kw):
    """Apply one mutation to the port's state and the reference's."""
    out = getattr(mutate, fn_name)(st, *args, **kw)
    jout = getattr(jx_mutate, fn_name)(jst, *args, **kw)
    if fn_name == "insert":
        np.testing.assert_array_equal(out[1], jout[1])
        return out[0], jout[0]
    return out, jout


@pytest.mark.parametrize("metric", METRICS)
def test_churn_stream_matches_oracle_and_reference(metric):
    """Interleaved insert/delete stream, checked after EVERY op."""
    rng = np.random.default_rng(3)
    d = 8 if metric == "hamming" else 16
    X = _vectors(rng, 40, d, metric)
    Q = _vectors(rng, 9, d, metric)
    st = mutate.BRUTEFORCE_SPEC.build(X, metric=metric, delta_capacity=32,
                                      device="cpu")
    jst = jx_mutate.BRUTEFORCE_SPEC.build(X, metric=metric,
                                          delta_capacity=32)
    script = [
        ("insert", 5), ("delete", [0, 1, 41]), ("insert", 3),
        ("delete", [43, 44, 7, 7]), ("insert", 1), ("compact", None),
        ("insert", 4), ("delete", [10, 48]),
    ]
    for op, arg in script:
        if op == "insert":
            st, jst = _both("insert", st, jst, _vectors(rng, arg, d, metric))
        elif op == "delete":
            st, jst = _both("delete", st, jst, arg)
        else:
            st, jst = _both("compact", st, jst)
        _assert_matches_oracle(st, Q, 10)
        _assert_matches_reference(st, jst, Q, 10)
        assert mutate.live_count(st) == jx_mutate.live_count(jst)
        assert mutate.delta_fraction(st) == jx_mutate.delta_fraction(jst)


@pytest.mark.parametrize("metric", METRICS)
def test_deleted_ids_never_appear_under_exact_ties(metric):
    """Duplicate rows tie EXACTLY; a tombstoned id must not ride the tie
    back in.  Held to the oracle (the reference is red for angular)."""
    rng = np.random.default_rng(5)
    d = 4 if metric == "hamming" else 8
    base = _vectors(rng, 10, d, metric)
    X = np.concatenate([base, base])          # ids 0..9 == ids 10..19
    st = mutate.BRUTEFORCE_SPEC.build(X, metric=metric, delta_capacity=8,
                                      device="cpu")
    st, _ = mutate.insert(st, base[:4])       # ids 20..23: third copies
    st = mutate.delete(st, [0, 10, 21, 3])
    _, ids = mutate.BRUTEFORCE_SPEC.search(st, base, k=20)
    ids = ids.numpy()
    assert not np.isin(ids, [0, 10, 21, 3]).any()
    assert 20 in ids[0] and 11 in ids[1]
    _assert_matches_oracle(st, base, 20)


@pytest.mark.parametrize("metric,rerank_kernel", [
    ("euclidean", False), ("euclidean", True), ("angular", True)])
def test_mutable_ivf_churn_matches_oracle_exhaustive(metric, rerank_kernel):
    """MutableIVF probing every list == exact over live rows, before and
    after the re-clustering compaction.  The angular case holds copies of
    rows in the main lists and in the delta, which must tie exactly: the
    list entry computes each distance alone, wherever the row sits (the
    torch fold's einsum does not, on the main index alone either)."""
    rng = np.random.default_rng(11)
    X = _vectors(rng, 60, 12, metric)
    Q = _vectors(rng, 7, 12, metric)
    new = _vectors(rng, 6, 12, metric)
    if metric == "angular":
        X[30:40] = X[:10]                      # ids 30..39 copy ids 0..9
        new[:4] = X[:4]                        # ids 60..63: third copies
        Q = np.concatenate([Q, X[:5]])
    st = mutate.IVF_SPEC.build(X, metric=metric, n_clusters=6,
                               delta_capacity=16, device="cpu",
                               rerank_kernel=rerank_kernel)
    st, _ = mutate.insert(st, new)
    st = mutate.delete(st, [0, 5, 62, 31])
    _assert_matches_oracle(st, Q, 10, n_probes=6)
    _, ids = mutate.IVF_SPEC.search(st, Q, k=10, n_probes=6)
    assert not np.isin(ids.numpy(), [0, 5, 62, 31]).any()
    st = mutate.compact(st)
    _assert_matches_oracle(st, Q, 10,
                           n_probes=st["main"].stat("n_clusters"))


@pytest.mark.parametrize("rerank_kernel", [False, True])
def test_mutable_ivf_sweep_equals_static_and_reference(rerank_kernel):
    """n_probes under max_probes (and the grid path) equals the static
    path at every value, across live mutation; the fold and kernel 2's
    list entry (its plain version here) give the same ids, and so does
    the reference on its own build of the same rows."""
    rng = np.random.default_rng(14)
    X = _vectors(rng, 80, 12, "euclidean")
    Q = _vectors(rng, 6, 12, "euclidean")
    st = mutate.IVF_SPEC.build(X, metric="euclidean", n_clusters=8,
                               delta_capacity=16, device="cpu",
                               rerank_kernel=rerank_kernel)
    st, _ = mutate.insert(st, _vectors(rng, 5, 12, "euclidean"))
    st = mutate.delete(st, [3, 81])
    bound = bind_search(mutate.IVF_SPEC.search, mutate.IVF_SPEC,
                        traced=("n_probes",))
    _, sweep = search_sweep_points(st, Q, k=5,
                                   points=[{"n_probes": p} for p in (1, 3, 8)])
    for row, p in enumerate((1, 3, 8)):
        _, got = bound(st, Q, k=5, n_probes=p, max_probes=8)
        _, want = mutate.IVF_SPEC.search(st, Q, k=5, n_probes=p,
                                         max_probes=8)
        assert torch.equal(got, want) and torch.equal(sweep[row], want)
        _, static = mutate.IVF_SPEC.search(st, Q, k=5, n_probes=p)
        assert torch.equal(static, want)
    _assert_matches_oracle(st, Q, 5, n_probes=8)


@pytest.mark.parametrize("metric", METRICS)
def test_bruteforce_distance_is_one_per_index(metric):
    """A BruteForce index answers a masked and an unmasked search by one
    distance expression; the mutable layer's main index (``exact_angular``)
    scans its delta by that same expression."""
    rng = np.random.default_rng(8)
    d = 4 if metric == "hamming" else 16
    X = _vectors(rng, 50, d, metric)
    Q = _vectors(rng, 6, d, metric)
    for st in (bruteforce.build(X, metric=metric, device="cpu"),
               bruteforce.exact_angular(
                   bruteforce.build(X, metric=metric, device="cpu"))):
        d0, i0 = bruteforce.search(st, Q, k=50)
        d1, i1 = bruteforce.search(
            st, Q, k=50, live=torch.ones(50, dtype=torch.bool))
        assert torch.equal(torch.sort(d0, dim=1).values,
                           torch.sort(d1, dim=1).values)
    mst = mutate.BRUTEFORCE_SPEC.build(X, metric=metric, delta_capacity=8,
                                       device="cpu")
    main = mst["main"]
    assert main.static.get("exact_angular")
    Qp = prepare_queries(Q, metric, "cpu")
    want = bruteforce.distance_matrix(main, Qp, main["X"],
                                      main.arrays.get("xsq"))[:, :8]
    mst, _ = mutate.insert(mst, X[:8])
    got = mutate.delta._delta_scan(mst, Qp, 10)[0][:, :8]
    assert torch.equal(got, want.to(torch.float32))


def test_upsert_tombstones_the_old_copy():
    rng = np.random.default_rng(2)
    X = _vectors(rng, 20, 8, "euclidean")
    st = mutate.BRUTEFORCE_SPEC.build(X, metric="euclidean",
                                      delta_capacity=8, device="cpu")
    jst = jx_mutate.BRUTEFORCE_SPEC.build(X, metric="euclidean",
                                          delta_capacity=8)
    moved = X[3:4] + 64.0
    st, jst = _both("insert", st, jst, moved, ids=[3])
    gids, rows = mutate.live_items(st)
    assert (gids == 3).sum() == 1 and len(gids) == 20
    np.testing.assert_array_equal(rows[gids == 3], moved)
    # re-upsert while the id lives in the DELTA: still exactly one copy
    st, jst = _both("insert", st, jst, X[3:4], ids=[3])
    gids, rows = mutate.live_items(st)
    assert (gids == 3).sum() == 1
    np.testing.assert_array_equal(rows[gids == 3], X[3:4])
    jgids, jrows = jx_mutate.live_items(jst)
    np.testing.assert_array_equal(gids, jgids)
    np.testing.assert_array_equal(rows, jrows)
    _assert_matches_oracle(st, X[:5], 6)
    _assert_matches_reference(st, jst, X[:5], 6)


def test_delete_is_idempotent_and_unknown_ids_are_noops():
    rng = np.random.default_rng(4)
    st = mutate.BRUTEFORCE_SPEC.build(_vectors(rng, 15, 8, "euclidean"),
                                      metric="euclidean", delta_capacity=4,
                                      device="cpu")
    st = mutate.delete(st, [2, 2, 99, -5])
    st = mutate.delete(st, [2])
    assert mutate.live_count(st) == 14
    assert mutate.delete(st, []) is st
    assert mutate.live_count(st) == 14


def _messages(fn, jfn):
    """The port and the reference raise the same type and message."""
    with pytest.raises(Exception) as got:
        fn()
    with pytest.raises(Exception) as want:
        jfn()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    return got.value


def test_delta_full_and_id_validation_messages():
    rng = np.random.default_rng(6)
    X = _vectors(rng, 10, 8, "euclidean")
    st = mutate.BRUTEFORCE_SPEC.build(X, metric="euclidean",
                                      delta_capacity=4, device="cpu")
    jst = jx_mutate.BRUTEFORCE_SPEC.build(X, metric="euclidean",
                                          delta_capacity=4)
    three = _vectors(rng, 3, 8, "euclidean")
    st, jst = _both("insert", st, jst, three)
    two = _vectors(rng, 2, 8, "euclidean")
    err = _messages(lambda: mutate.insert(st, two),
                    lambda: jx_mutate.insert(jst, two))
    assert isinstance(err, mutate.DeltaFull)
    assert "3/4" in str(err) and "compact" in str(err)
    one = two[:1]
    for rows, ids in ((two, [5, 5]), (one, [-1]), (one, [1, 2])):
        _messages(lambda: mutate.insert(st, rows, ids=ids),
                  lambda: jx_mutate.insert(jst, rows, ids=ids))
    st = mutate.compact(st)
    st, _ = mutate.insert(st, _vectors(rng, 4, 8, "euclidean"))
    assert mutate.delta_fraction(st) == 1.0
    # fresh allocation continues past the largest explicit id
    st2 = mutate.BRUTEFORCE_SPEC.build(X, metric="euclidean",
                                       delta_capacity=8, device="cpu")
    st2, _ = mutate.insert(st2, one, ids=[50])
    st2, ids = mutate.insert(st2, one)
    assert list(ids) == [51]


def test_mutation_rejects_frozen_quantized_and_pallas_states():
    rng = np.random.default_rng(9)
    X = _vectors(rng, 32, 16, "euclidean")
    frozen = bruteforce.build(X[:10, :8], metric="euclidean", device="cpu")
    from repro.ann import bruteforce as jx_bf

    jfrozen = jx_bf.build(X[:10, :8], metric="euclidean")
    row = X[:1, :8]
    for fn, args in (("insert", (row,)), ("delete", ([0],)),
                     ("compact", ())):
        err = _messages(lambda: getattr(mutate, fn)(frozen, *args),
                        lambda: getattr(jx_mutate, fn)(jfrozen, *args))
        assert "mutable" in str(err)
    for kw in ({"quantize": "int8"}, {"backend": "pallas"}):
        _messages(
            lambda: mutate.BRUTEFORCE_SPEC.build(X, metric="euclidean",
                                                 device="cpu", **kw),
            lambda: jx_mutate.BRUTEFORCE_SPEC.build(X, metric="euclidean",
                                                    **kw))


def test_compact_grows_slots_when_live_outgrows_them():
    rng = np.random.default_rng(13)
    st = mutate.BRUTEFORCE_SPEC.build(_vectors(rng, 6, 8, "euclidean"),
                                      metric="euclidean", delta_capacity=4,
                                      device="cpu")
    assert st["main"].stat("n") == 10
    for _ in range(3):
        st, _ = mutate.insert(st, _vectors(rng, 4, 8, "euclidean"))
        st = mutate.compact(st)
    assert mutate.live_count(st) == 18
    assert st["main"].stat("n") == 18
    _assert_matches_oracle(st, _vectors(rng, 3, 8, "euclidean"), 10)


def test_compaction_keeps_the_slot_count_and_the_answers():
    rng = np.random.default_rng(12)
    X = _vectors(rng, 30, 8, "euclidean")
    Q = _vectors(rng, 4, 8, "euclidean")
    st = mutate.BRUTEFORCE_SPEC.build(X, metric="euclidean",
                                      delta_capacity=8, device="cpu")
    for _ in range(3):
        st, _ = mutate.insert(st, _vectors(rng, 2, 8, "euclidean"))
        st = mutate.delete(st, [int(rng.integers(0, 30))])
    before = mutate.BRUTEFORCE_SPEC.search(st, Q, k=5)
    st = mutate.compact(st)
    assert st["main"].stat("n") == 38         # 30 + delta_capacity
    after = mutate.BRUTEFORCE_SPEC.search(st, Q, k=5)
    assert torch.equal(before[0], after[0]) and torch.equal(before[1],
                                                            after[1])
    _assert_matches_oracle(st, Q, 5)


@pytest.mark.parametrize("algo", ["MutableBruteForce", "MutableIVF"])
def test_older_states_answer_as_before(algo):
    """insert / delete / compact return new states; every older state
    keeps its tensors and its answers (no in-place update is shared)."""
    rng = np.random.default_rng(21)
    X = _vectors(rng, 50, 8, "euclidean")
    Q = _vectors(rng, 5, 8, "euclidean")
    spec = mutate.BRUTEFORCE_SPEC if algo == "MutableBruteForce" \
        else mutate.IVF_SPEC
    kw = {} if algo == "MutableBruteForce" else {"n_clusters": 4}
    knobs = {} if algo == "MutableBruteForce" else {"n_probes": 4}
    st = spec.build(X, metric="euclidean", delta_capacity=8, device="cpu",
                    **kw)
    history = []
    for step in range(4):
        history.append((st, spec.search(st, Q, k=6, **knobs),
                        {k: v.clone() for k, v in st.arrays.items()
                         if torch.is_tensor(v)}))
        st, _ = mutate.insert(st, _vectors(rng, 2, 8, "euclidean"))
        st = mutate.delete(st, [step, 50 + step])
        if step == 2:
            st = mutate.compact(st)
    for old, (d0, i0), tensors in history:
        d1, i1 = spec.search(old, Q, k=6, **knobs)
        assert torch.equal(d0, d1) and torch.equal(i0, i1)
        for name, t in tensors.items():
            assert torch.equal(old[name], t), name


def test_registry_and_index_size():
    """The two specs are registered with the reference's names, knobs and
    metrics, and a mutable state counts its main index's bytes."""
    from repro.ann.functional import get_functional as jx_get
    from repro_torch.ann.functional import get_functional
    from repro_torch.core.registry import resolve

    for name in ("MutableBruteForce", "MutableIVF"):
        got, want = get_functional(name), jx_get(name)
        assert got.query_params == want.query_params
        assert got.traced_knobs == want.traced_knobs
        assert got.supported_metrics == want.supported_metrics
        assert resolve(name).registry_name == name
    rng = np.random.default_rng(1)
    X = _vectors(rng, 20, 8, "euclidean")
    st = mutate.BRUTEFORCE_SPEC.build(X, metric="euclidean",
                                      delta_capacity=4, device="cpu")
    assert st.nbytes() > st["main"].nbytes() > 0
    algo = resolve("MutableIVF")("euclidean", n_clusters=4,
                                 delta_capacity=8)
    algo.fit(X, device="cpu")
    assert algo.name == "MutableIVF(C=4, cap=8)"
    assert algo.batch_query(X[:3], 3) is None
    assert algo.get_batch_results().shape == (3, 3)


try:
    from hypothesis import given, settings, strategies as st_
    HAVE_HYPOTHESIS = True
except ImportError:                                    # pragma: no cover
    HAVE_HYPOTHESIS = False


def _property_stream(data, metric, seed):
    """An arbitrary interleaved insert/delete/compact stream equals the
    live-row oracle at every step, all three metrics, ties included
    (``tests/test_mutate.py::_property_stream``)."""
    rng = np.random.default_rng(seed)
    d = 4 if metric == "hamming" else 6
    n0 = data.draw(st_.integers(4, 20), label="n0")
    cap = data.draw(st_.integers(4, 12), label="delta_capacity")
    X = _vectors(rng, n0, d, metric)
    Q = _vectors(rng, 4, d, metric)
    state = mutate.BRUTEFORCE_SPEC.build(X, metric=metric,
                                         delta_capacity=cap, device="cpu")
    known = list(range(n0))
    n_ops = data.draw(st_.integers(1, 8), label="n_ops")
    for _ in range(n_ops):
        op = data.draw(st_.sampled_from(
            ["insert", "insert_dup", "delete", "compact"]))
        if op == "compact":
            state = mutate.compact(state)
        elif op == "delete":
            dels = data.draw(st_.lists(
                st_.sampled_from(known + [10**6]), max_size=4))
            state = mutate.delete(state, np.asarray(dels, np.int32)
                                  if dels else [])
        else:
            m = data.draw(st_.integers(1, 3), label="m")
            if op == "insert_dup" and known:
                gids, rows = mutate.live_items(state)
                take = rng.choice(len(rows), size=min(m, len(rows)),
                                  replace=False)
                batch = rows[take]
            else:
                batch = _vectors(rng, m, d, metric)
            try:
                state, new_ids = mutate.insert(state, batch)
            except mutate.DeltaFull:
                state = mutate.compact(state)
                state, new_ids = mutate.insert(state, batch)
            known.extend(int(i) for i in new_ids)
        k = data.draw(st_.integers(1, 12), label="k")
        _assert_matches_oracle(state, Q, k)


if HAVE_HYPOTHESIS:
    @settings(max_examples=12, deadline=None)
    @given(data=st_.data(),
           metric=st_.sampled_from(list(METRICS)),
           seed=st_.integers(0, 2**31 - 1))
    def test_property_churn_stream_matches_oracle(data, metric, seed):
        _property_stream(data, metric, seed)
