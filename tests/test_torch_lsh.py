"""The LSH pair (``ann/lsh.py``) and RPForest (``ann/rpforest.py``) of the
port against the JAX package on the same numpy inputs.

Hash keys and tree descents threshold a float projection (``proj > 0``,
``floor(proj)``, the sign of a split margin), and a projection computed by
torch and by XLA may differ in its last bits.  So:

  * build keys are compared everywhere except where the reference's
    pre-threshold value, recomputed in float64, lies within ``TOL`` of a
    boundary; those exceptions are counted and must stay under 1 % of the
    entries;
  * searches run on the reference's own state, carried across with
    ``convert.state_from_reference``; a query may differ only where its
    own projections (or the order they impose on the multiprobe flips)
    lie within ``TOL`` of a boundary, such queries are counted (<= 5 %),
    and every other query must give the reference's ids bitwise and its
    distances to rtol=1e-5, atol=1e-4;
  * the host-built forests (numpy, draw for draw the reference's) are
    bitwise equal;
  * a traced knob (a ``max_*`` cap plus a mask) equals the static window:
    ids bitwise, distances to rtol=1e-5, atol=1e-4 (the rerank's matmul
    sees another window shape, which may move the last bits).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.ann import lsh as jx_lsh  # noqa: E402
from repro.ann import rpforest as jx_rp  # noqa: E402
from repro_torch.ann import lsh, rpforest  # noqa: E402
from repro_torch.ann.lsh import _wrap32  # noqa: E402
from repro_torch.convert import state_from_reference  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
TOL = 1e-4


def _data(metric, n=1500, nq=40, d=24, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = (X[rng.integers(0, n, nq)]
         + 0.3 * rng.standard_normal((nq, d))).astype(np.float32)
    return X, Q


def _carry(ref, **static):
    return state_from_reference(
        ref.algo, ref.metric, {k: np.asarray(v) for k, v in ref.arrays.items()},
        dict(ref.static, **static), device="cpu")


def _keys_by_point(state):
    keys, ids = (np.asarray(state[k]) for k in ("keys", "ids"))
    out = np.empty_like(keys)
    np.put_along_axis(out, ids.astype(np.int64), keys, axis=1)
    return out


def _compare(want, got, flagged):
    """Rows not flagged: ids bitwise, distances to the tolerance.  Returns
    the number of flagged rows that differ."""
    wd, wi = (np.asarray(a) for a in want)
    gd, gi = (a.numpy() for a in got)
    assert gi.shape == wi.shape and gi.dtype == np.int32
    ok = ~flagged
    np.testing.assert_array_equal(gi[ok], wi[ok])
    np.testing.assert_allclose(gd[ok], wd[ok], rtol=RTOL, atol=ATOL)
    return int((gi[flagged] != wi[flagged]).any(axis=1).sum())


def _cut_tie(vals, n_first):
    """[..., m] values: does the sorted order put a near tie across the
    cut after ``n_first`` entries (which entries get picked may differ)?"""
    s = np.sort(vals, axis=-1)
    if n_first <= 0 or n_first >= s.shape[-1]:
        return np.zeros(s.shape[:-1], bool)
    with np.errstate(invalid="ignore"):          # inf - inf past a leaf
        return np.abs(s[..., n_first] - s[..., n_first - 1]) < TOL


# ------------------------------------------------------------ primitives
def test_wrap32_is_int32_wraparound():
    rng = np.random.default_rng(0)
    a = rng.integers(-2**31, 2**31, 1000, dtype=np.int64)
    b = rng.integers(-2**31, 2**31, 1000, dtype=np.int64)
    with np.errstate(over="ignore"):
        want = a.astype(np.int32) * b.astype(np.int32)
    got = _wrap32(torch.as_tensor(a) * torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got.astype(np.int32), want)
    assert np.array_equal(
        _wrap32(torch.tensor([2**31, -2**31 - 1, 2**32 + 5])).numpy(),
        [-2**31, 2**31 - 1, 5])


def test_bucket_lookup_matches_reference():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 50, (3, 400)).astype(np.int32)
    tk, ti = jx_lsh.sorted_buckets(keys)
    pk, pi = lsh.sorted_buckets(keys, "cpu")
    np.testing.assert_array_equal(pk.numpy(), np.asarray(tk))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ti))
    q = rng.integers(-1, 55, (7, 3, 4)).astype(np.int32)
    want = jx_lsh.bucket_lookup(tk, ti, jnp.asarray(q), 6)
    got = lsh.bucket_lookup(pk, pi, torch.as_tensor(q), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ hyperplane
def _hyperplane_flags(state, Q, probes):
    planes = np.asarray(state["planes"], np.float64)
    Qn = Q / np.linalg.norm(Q, axis=1, keepdims=True)
    proj = np.einsum("lbd,qd->qlb", planes, Qn.astype(np.float64))
    flag = (np.abs(proj) < TOL).any(axis=(1, 2))
    if probes > 1:
        nflip = min(probes - 1, proj.shape[-1])
        flag |= _cut_tie(np.abs(proj), nflip).any(axis=1)
    return flag


def test_hyperplane_build_keys_match_reference():
    X, _ = _data("angular")
    ref = jx_lsh.hyperplane_build(X, n_tables=4, n_bits=12, cap=16, seed=3)
    st = lsh.hyperplane_build(X, n_tables=4, n_bits=12, cap=16, seed=3,
                              device="cpu")
    assert st.static == ref.static
    np.testing.assert_array_equal(st["planes"].numpy(),
                                  np.asarray(ref["planes"]))
    Xn = X / np.linalg.norm(X, axis=1, keepdims=True)
    proj = np.einsum("lbd,nd->lnb", np.asarray(ref["planes"], np.float64),
                     Xn.astype(np.float64))
    near = (np.abs(proj) < TOL).any(axis=-1)              # [L, n]
    same = _keys_by_point(st) == _keys_by_point(ref)
    assert same[~near].all()
    assert near.sum() <= 0.01 * near.size


@pytest.mark.parametrize("kw", [
    {"n_probes": 1}, {"n_probes": 4}, {"n_probes": 3, "tables": 2},
    {"n_probes": 2, "max_probes": 5, "tables": 3, "max_tables": 4}])
@pytest.mark.parametrize("rerank_kernel", [False, True])
def test_hyperplane_search_on_reference_state(kw, rerank_kernel):
    X, Q = _data("angular", seed=1)
    ref = jx_lsh.hyperplane_build(X, n_tables=4, n_bits=10, cap=24, seed=1)
    st = _carry(ref, rerank_kernel=rerank_kernel)
    want = jx_lsh.hyperplane_search(ref, jnp.asarray(Q), k=10, **kw)
    got = lsh.hyperplane_search(st, Q, k=10, **kw)
    flags = _hyperplane_flags(ref, Q, kw.get("max_probes", kw["n_probes"]))
    assert flags.sum() <= 0.05 * len(Q)
    _compare(want, got, flags)


# ----------------------------------------------------------------- E2LSH
def _e2_proj(state, A):
    a = np.asarray(state["a"], np.float64)
    b = np.asarray(state["b"], np.float64)
    return (np.einsum("lmd,nd->lnm", a, A.astype(np.float64))
            + b[:, None, :]) / state.stat("w_eff")


def test_e2lsh_build_keys_match_reference():
    X, _ = _data("euclidean", seed=2)
    ref = jx_lsh.e2lsh_build(X, n_tables=4, n_hashes=6, width=2.0, seed=5)
    st = lsh.e2lsh_build(X, n_tables=4, n_hashes=6, width=2.0, seed=5,
                         device="cpu")
    assert st.static == ref.static
    for name in ("a", "b", "combine", "xsq"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-6)
    proj = _e2_proj(ref, X)
    frac = proj - np.floor(proj)
    near = (np.minimum(frac, 1 - frac) < TOL).any(axis=-1)     # [L, n]
    same = _keys_by_point(st) == _keys_by_point(ref)
    assert same[~near].all()
    assert near.sum() <= 0.01 * near.size


def test_e2lsh_keys_wrap_like_int32():
    """The combine coefficients are ~2**30, so the int32 products and
    their sum wrap in the reference; the port's keys must wrap alike (a
    plain int64 sum gives other keys for a good share of the points)."""
    X, _ = _data("euclidean", n=300, seed=4)
    ref = jx_lsh.e2lsh_build(X, n_tables=2, n_hashes=8, seed=4)
    h, _ = jx_lsh._e2_hash(ref, jnp.asarray(X))
    want = np.asarray(jx_lsh._e2_key(ref, h))
    st = _carry(ref)
    got = lsh._e2_key(st, torch.as_tensor(np.array(h)))
    np.testing.assert_array_equal(got.numpy(), want)
    unwrapped = (np.asarray(h, np.int64)
                 * np.asarray(ref["combine"], np.int64)[:, None, :]).sum(-1)
    assert (unwrapped % (2**31 - 1) != want).mean() > 0.05


@pytest.mark.parametrize("kw", [
    {"n_probes": 1}, {"n_probes": 5}, {"n_probes": 3, "tables": 2},
    {"n_probes": 3, "max_probes": 6, "tables": 2, "max_tables": 4}])
@pytest.mark.parametrize("rerank_kernel", [False, True])
def test_e2lsh_search_on_reference_state(kw, rerank_kernel):
    X, Q = _data("euclidean", seed=3)
    ref = jx_lsh.e2lsh_build(X, n_tables=4, n_hashes=6, width=2.0, cap=24,
                             seed=3)
    st = _carry(ref, rerank_kernel=rerank_kernel)
    want = jx_lsh.e2lsh_search(ref, jnp.asarray(Q), k=10, **kw)
    got = lsh.e2lsh_search(st, Q, k=10, **kw)
    proj = _e2_proj(ref, Q)                               # [L, q, m]
    frac = proj - np.floor(proj)
    flags = (np.minimum(frac, 1 - frac) < TOL).any(axis=(0, 2))
    probes = kw.get("max_probes", kw["n_probes"])
    if probes > 1:
        cost = np.concatenate([frac, 1 - frac], axis=-1)
        flags |= _cut_tie(cost, min(probes - 1, cost.shape[-1])).any(axis=0)
    assert flags.sum() <= 0.05 * len(Q)
    _compare(want, got, flags)


@pytest.mark.parametrize("algo", ["hyperplane", "e2lsh"])
def test_lsh_traced_knobs_equal_static_window(algo):
    metric = "angular" if algo == "hyperplane" else "euclidean"
    X, Q = _data(metric, seed=6)
    build = getattr(lsh, f"{algo}_build")
    search = getattr(lsh, f"{algo}_search")
    st = build(X, n_tables=4, cap=16, seed=6, device="cpu")
    for n_probes, tables in [(1, 1), (2, 3), (4, 4)]:
        want = search(st, Q, k=10, n_probes=n_probes, tables=tables)
        got = search(st, Q, k=10, n_probes=torch.tensor(n_probes),
                     max_probes=4, tables=torch.tensor(tables), max_tables=4)
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------- RPForest
@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_rpforest_build_bitwise(metric):
    X, _ = _data(metric, n=900, seed=7)
    ref = jx_rp.build(X, metric=metric, n_trees=4, leaf_size=16, seed=7)
    st = rpforest.build(X, metric=metric, n_trees=4, leaf_size=16, seed=7,
                        device="cpu")
    assert st.static == ref.static and set(st.arrays) == set(ref.arrays)
    for name in ("normals", "offsets", "children", "leaf_pts", "roots", "X"):
        np.testing.assert_array_equal(st[name].numpy(),
                                      np.asarray(ref[name]))


def _rp_flags(ref, Q, probe):
    """Queries with a split margin within TOL of 0 on a visited path, or a
    near tie across the cut of the spill order (reference's own margins)."""
    Qj = jx_rp.prepare_queries(jnp.asarray(Q), ref.metric)
    T = ref.stat("n_trees")
    start = jnp.broadcast_to(ref["roots"][None, :T], (Q.shape[0], T))
    _, margins, others = jx_rp._descend(ref, Qj, start)
    m = np.asarray(margins)
    flag = (m < TOL).any(axis=(1, 2))
    if probe > 1:
        nprobe = min(probe - 1, m.shape[-1])
        flag |= _cut_tie(m, nprobe).any(axis=1)
        order = np.argsort(m, axis=-1, kind="stable")[..., :nprobe]
        alt = np.take_along_axis(np.asarray(others), order, axis=-1)
        for p in range(nprobe):
            _, am, _ = jx_rp._descend(ref, Qj, jnp.asarray(alt[..., p]))
            flag |= (np.asarray(am) < TOL).any(axis=(1, 2))
    return flag


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("kw", [
    {"probe": 1}, {"probe": 4}, {"probe": 3, "trees": 2},
    {"probe": 2, "max_probe": 5, "trees": 3, "max_trees": 4}])
def test_rpforest_search_on_reference_state(metric, kw):
    X, Q = _data(metric, seed=8)
    ref = jx_rp.build(X, metric=metric, n_trees=4, leaf_size=16, seed=8)
    st = _carry(ref, rerank_kernel=True)
    want = jx_rp.search(ref, jnp.asarray(Q), k=10, **kw)
    got = rpforest.search(st, Q, k=10, **kw)
    flags = _rp_flags(ref, Q, kw.get("max_probe", kw["probe"]))
    assert flags.sum() <= 0.05 * len(Q)
    _compare(want, got, flags)


def test_rpforest_traced_knobs_equal_static_window():
    X, Q = _data("euclidean", seed=9)
    st = rpforest.build(X, n_trees=5, leaf_size=16, seed=9, device="cpu")
    for probe, trees in [(1, 1), (3, 2), (5, 5)]:
        want = rpforest.search(st, Q, k=10, probe=probe, trees=trees)
        got = rpforest.search(st, Q, k=10, probe=torch.tensor(probe),
                              max_probe=5, trees=torch.tensor(trees),
                              max_trees=5)
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cls,metric,args", [
    ("HyperplaneLSH", "angular", (4, 10, 24, 1)),
    ("E2LSH", "euclidean", (4, 6, 2.0, 24, 1)),
    ("RPForest", "euclidean", (4, 16, 1))])
def test_legacy_classes_match_reference(cls, metric, args):
    """The BaseANN adapters: same names, batch results and dist_comps as
    the reference on the same data (queries away from boundaries)."""
    import repro.ann as jx_ann
    import repro_torch.ann as port_ann

    X, Q = _data(metric, seed=10)
    want = getattr(jx_ann, cls)(metric, *args)
    got = getattr(port_ann, cls)(metric, *args)
    want.fit(X)
    got.fit(X, device="cpu")
    assert got.name == want.name
    want.set_query_arguments(2)
    got.set_query_arguments(2)
    want.batch_query(Q, 10)
    got.batch_query(Q, 10)
    w = np.asarray(want.get_batch_results())
    g = got.get_batch_results()
    assert g.shape == w.shape
    assert (g == w).all(axis=1).mean() >= 0.9
    assert got.get_additional() == want.get_additional()
