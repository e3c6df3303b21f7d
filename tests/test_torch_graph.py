"""The graph family of the port (``ann/graph.py``: KNNGraph, ``ann/hnsw.py``:
HNSW) against the JAX package on the same numpy inputs.

* Builds: KNNGraph's ``graph`` and ``entries`` and HNSW's ``layers``,
  ``entry`` and ``top`` bit for bit.  KNNGraph takes its edges from
  ``exact_knn``, whose distances torch and XLA may round apart in the last
  bit; a row whose edges differ is counted (<= 1 % of rows) and, without
  diversification, must hold the same edges up to a near tie.
* Searches run on the reference's own state, carried across with
  ``convert.state_from_reference``.  On integer-valued data (angular rows
  with four entries of +-1, so that the unit rows hold +-0.5) every fp32
  operation is exact and ties are many, so ids, distances and expansions
  are held bit for bit: the static ``ef``, ``ef`` as a runtime value under
  ``max_ef`` (the reference's jitted traced path, the port's
  ``bind_search``), ef < k and k > cap.  On gaussian blobs the dot
  products' order may move a last bit: ids and expansions must agree in at
  least 99 % of queries, distances within rtol 1e-5, atol 1e-5
  (``test_torch_distances``' tolerance for ``masked_rows_to``).
* The legacy classes: records, ``get_additional`` and ``index_size``
  equal to the reference's after the same ``run_definition``, in batch
  mode (the grid sweep) and in single mode.

Each reference state is built once (``_ref_state``), and the legacy
classes' two modes share each package's build (``graph_build_cache``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from graph_build_cache import shared_graph_builds  # noqa: E402

from repro.ann import graph as jx_graph  # noqa: E402
from repro.ann import hnsw as jx_hnsw  # noqa: E402
from repro.ann.functional import get_functional as jx_spec  # noqa: E402
from repro.ann.functional import jit_search_fn  # noqa: E402
from repro_torch.ann import graph, hnsw  # noqa: E402
from repro_torch.ann.functional import (bind_search, get_functional,  # noqa: E402
                                        search_sweep_points)
from repro_torch.convert import state_from_reference  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
TOL = 1e-4
K = 10
ALGOS = {"KNNGraph": (jx_graph, graph, {}),
         "HNSW": (jx_hnsw, hnsw, {"M": 8, "ef_construction": 40})}


def _carry(ref):
    arrays = {k: tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
              else np.asarray(v) for k, v in ref.arrays.items()}
    return state_from_reference(ref.algo, ref.metric, arrays, ref.static,
                                device="cpu")


def _blobs(n=500, nq=100, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.standard_normal((8, d))
    X = centers[rng.integers(0, 8, n)] + rng.standard_normal((n, d))
    Q = centers[rng.integers(0, 8, nq)] + rng.standard_normal((nq, d))
    return X.astype(np.float32), Q.astype(np.float32)


def _integer(metric, n=400, nq=40, d=16, seed=0):
    rng = np.random.default_rng(seed)
    if metric == "euclidean":
        return (rng.integers(-3, 4, (n, d)).astype(np.float32),
                rng.integers(-3, 4, (nq, d)).astype(np.float32))

    def rows(m):
        out = np.zeros((m, d), np.float32)
        for r in out:
            r[rng.choice(d, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
        return out

    return rows(n), rows(nq)


_STATES = {}


def _ref_state(algo, metric, data):
    key = (algo, metric, data)
    if key not in _STATES:
        X, Q = _integer(metric) if data == "integer" else _blobs()
        jx_mod, _, params = ALGOS[algo]
        _STATES[key] = (jx_mod.build(X, metric=metric, **params), Q)
    return _STATES[key]


# ------------------------------------------------------------------ builds
@pytest.mark.parametrize("extra_edges", [0, 2])
@pytest.mark.parametrize("diversify", [False, True])
@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_knngraph_build_matches_reference(metric, diversify, extra_edges):
    X, _ = _blobs()
    params = dict(metric=metric, degree=12, diversify=diversify,
                  extra_edges=extra_edges, n_entries=8, seed=3)
    ref = jx_graph.build(X, **params)
    st = graph.build(X, device="cpu", **params)
    assert st.static == ref.static
    np.testing.assert_array_equal(st["entries"].numpy(),
                                  np.asarray(ref["entries"]))
    want, got = np.asarray(ref["graph"]), st["graph"].numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    deg = ref.stat("degree")
    # the random shortcuts do not depend on the edges: always bit for bit
    np.testing.assert_array_equal(got[:, deg:], want[:, deg:])
    rows = np.flatnonzero((got[:, :deg] != want[:, :deg]).any(axis=1))
    assert len(rows) <= X.shape[0] // 100, f"{len(rows)} rows differ"
    if not diversify:
        Xp = graph.prepare_points(X, metric).astype(np.float64)
        for i in rows:
            def dist(ids):
                x = Xp[ids]
                if metric == "angular":
                    return np.sort(1.0 - x @ Xp[i])
                return np.sort(np.sum((x - Xp[i]) ** 2, axis=1))
            np.testing.assert_allclose(dist(got[i, :deg]),
                                       dist(want[i, :deg]), atol=TOL)


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_hnsw_build_matches_reference(metric):
    ref, _ = _ref_state("HNSW", metric, "blobs")
    X, _ = _blobs()
    st = hnsw.build(X, metric=metric, device="cpu", **ALGOS["HNSW"][2])
    assert st.static == ref.static
    assert ref.stat("top") >= 1          # a hierarchy, not one layer
    assert len(st["layers"]) == len(ref["layers"]) == ref.stat("top") + 1
    for got, want in zip(st["layers"], ref["layers"]):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(st["X"].numpy(), np.asarray(ref["X"]))
    assert st.nbytes() == ref.nbytes()


def test_carried_state_counts_every_layer():
    """``state_from_reference`` maps HNSW's tuple of layers (one width per
    level) to a tuple of tensors, and ``nbytes`` counts each of them."""
    ref, _ = _ref_state("HNSW", "euclidean", "integer")
    st = _carry(ref)
    assert isinstance(st["layers"], tuple)
    assert [tuple(t.shape) for t in st["layers"]] == \
        [tuple(a.shape) for a in ref["layers"]]
    assert st.nbytes() == ref.nbytes() > st["X"].numel() * 4


# ---------------------------------------------------------------- searches
_JITTED = {}


def _ref_search(algo, ref, Q, **kw):
    traced = ("ef",) if "max_ef" in kw else ()
    if (algo, traced) not in _JITTED:      # one trace per cap, as a sweep
        _JITTED[algo, traced] = jit_search_fn(
            ALGOS[algo][0].search_with_stats, jx_spec(algo), traced=traced)
    fn = _JITTED[algo, traced]
    return [np.asarray(a) for a in jax.block_until_ready(fn(ref, Q, **kw))]


def _port_search(algo, st, Q, **kw):
    mod = ALGOS[algo][1]
    traced = ("ef",) if "max_ef" in kw else ()
    fn = bind_search(mod.search_with_stats, get_functional(algo),
                     traced=traced)
    return [a.numpy() for a in fn(st, Q, **kw)]


# (ef, max_ef): the static path; ef < k (the static output is ef wide);
# ef under a cap, twice (one reference trace serves both), the second with
# ef < k < cap, whose tail is (+inf, -1) padding
SEARCHES = {"static": [(16, None)], "narrow": [(6, None)],
            "traced": [(16, 24), (6, 24)]}


@pytest.mark.parametrize("mode", sorted(SEARCHES))
@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_search_bitwise_on_integer_data(algo, metric, mode):
    ref, Q = _ref_state(algo, metric, "integer")
    st = _carry(ref)
    for ef, max_ef in SEARCHES[mode]:
        kw = dict(k=K, ef=ef) if max_ef is None else \
            dict(k=K, ef=ef, max_ef=max_ef)
        wd, wi, wit = _ref_search(algo, ref, Q, **kw)
        gd, gi, git = _port_search(algo, st, Q, **kw)
        assert gi.dtype == np.int32 and git.dtype == np.int32
        assert gi.shape == wi.shape == (Q.shape[0], min(K, max_ef or ef))
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(git, wit)
        assert (git > 0).all()
        if max_ef is not None and ef < K:
            assert (gi[:, ef:] == -1).all() and np.isinf(gd[:, ef:]).all()


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_search_on_blobs_agrees(algo, metric):
    ref, Q = _ref_state(algo, metric, "blobs")
    wd, wi, wit = _ref_search(algo, ref, Q, k=K, ef=32)
    gd, gi, git = _port_search(algo, _carry(ref), Q, k=K, ef=32)
    same = (gi == wi).all(axis=1) & (git == wit)
    assert same.sum() >= 0.99 * Q.shape[0], \
        f"{(~same).sum()} of {Q.shape[0]} queries differ"
    np.testing.assert_allclose(gd[same], wd[same], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_sweep_points_equal_static_searches(algo):
    """The grid path's rows (ef 16 and 64 under one cap of 64) equal two
    static searches bit for bit."""
    ref, Q = _ref_state(algo, "euclidean", "blobs")
    st = _carry(ref)
    spec = get_functional(algo)
    d, ids = search_sweep_points(st, Q, k=K, points=[{"ef": 16}, {"ef": 64}])
    for row, ef in enumerate((16, 64)):
        sd, si = spec.search(st, Q, k=K, ef=ef)
        np.testing.assert_array_equal(ids[row].numpy(), si.numpy())
        np.testing.assert_array_equal(d[row].numpy(), sd.numpy())


# ----------------------------------------------------------- legacy classes
ARGS = {"KNNGraph": (12, False, 2, 8), "HNSW": (8, 40)}


@pytest.fixture(scope="module")
def shared_builds():
    with shared_graph_builds():
        yield


@pytest.mark.parametrize("batch", [True, False], ids=["grid", "single"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_legacy_class_matches_reference(algo, batch, shared_builds):
    """The same definition through both packages' ``run_definition``:
    equal neighbours, ``get_additional`` and index size (both modes on the
    same points: each package builds them once)."""
    from repro.core.config import Definition as JxDefinition
    from repro.core.experiment import (ExperimentSettings as
                                       JxSettings, run_definition as jx_run)
    from repro.data.datasets import Dataset as JxDataset
    from repro_torch.core.config import Definition
    from repro_torch.core.experiment import ExperimentSettings, run_definition
    from repro_torch.data.datasets import Dataset
    from repro_torch.data.groundtruth import exact_knn

    X, Q = _blobs(nq=40 if batch else 12, seed=2)
    nbrs, dists = exact_knn(X, Q, K, "euclidean", device="cpu")
    fields = dict(name="blobs-graph", train=X, test=Q, neighbors=nbrs,
                  distances=dists, metric="euclidean")
    groups = ((16,), (32,)) if batch else ((16,),)
    defn = dict(algorithm=algo.lower(), constructor=algo, module=None,
                arguments=("euclidean",) + ARGS[algo],
                query_argument_groups=groups)
    want = jx_run(JxDefinition(**defn), JxDataset(**fields),
                  JxSettings(count=K, batch_mode=batch))
    got = run_definition(Definition(**defn), Dataset(**fields),
                         ExperimentSettings(count=K, batch_mode=batch,
                                            device="cpu"))
    assert len(got) == len(want) == len(groups)
    for g, w in zip(got, want):
        assert g.instance_name == w.instance_name
        assert g.query_arguments == w.query_arguments
        assert g.index_size_kb == w.index_size_kb
        assert g.attrs.get("grid_sweep", False) is batch
        np.testing.assert_array_equal(g.neighbors, w.neighbors)
        drop = ("rss_delta_kb",)
        assert {k: v for k, v in g.attrs.items() if k not in drop} == \
            {k: v for k, v in w.attrs.items() if k not in drop}
        if not batch:
            assert g.attrs["dist_comps"] > 0
