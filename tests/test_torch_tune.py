"""The port's sweeps and tuner (``repro_torch.ann.functional.grid_combos``
/ ``search_sweep``, ``repro_torch.tune``, ``repro_torch.launch.knobs`` /
``tune``) against the JAX package on the same numpy inputs.

  * ``grid_combos``, ``select`` and ``_pareto_points``: equal outputs.
  * ``search_sweep``: every ``SWEEP_CASES`` / ``MULTIKNOB_CASES`` entry of
    ``tests/test_sweep.py`` the port has, on the reference's own index
    (``convert.state_from_reference``), row by row.  Ids are bit for bit,
    except that a query of an algorithm that thresholds a float at query
    time (a hash, a tree descent, an ADC sum's order, a beam's float
    compares) may differ where that float sits within ~1e-4 of its
    boundary (ROADMAP §3): such queries are counted, at most 5 % of a row,
    and distances of the others agree to rtol=1e-5, atol=1e-4.
  * ``grid_search``: the same params and recalls (one neighbour of
    slack, 1 / (nq k)); QPS is each package's own.
  * ``launch.knobs``: identical values and ``SystemExit`` texts.
  * ``launch.tune.main(..., "--device", "cpu")``: the JSON's params and
    recalls equal the reference CLI's.

The sweep, tuner and compressed benches are held in
``tests/test_torch_tune_benches.py``.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.data.datasets as jx_datasets  # noqa: E402
from graph_build_cache import shared_graph_builds  # noqa: E402
from repro import mutate as jx_mutate  # noqa: E402
from repro import tune as jx_tune  # noqa: E402
from repro.ann import functional as jx_functional  # noqa: E402
from repro.launch import knobs as jx_knobs  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.ann import functional  # noqa: E402
from repro_torch.ann.functional import IndexState  # noqa: E402
from repro_torch.convert import state_from_reference  # noqa: E402
from repro_torch.launch import knobs  # noqa: E402
from test_sweep import MULTIKNOB_CASES, SWEEP_CASES  # noqa: E402

K = 10
NQ = 16
RTOL, ATOL = 1e-5, 1e-4
# algorithms whose query path thresholds no float: ids bit for bit
EXACT = {"IVF", "MutableIVF", "BitsamplingAnnoy", "MultiIndexHashing"}
PORTED = sorted(n for n in SWEEP_CASES if n != "ShardedIVF")


def _carry(ref) -> IndexState:
    """The reference's state as a port state (a mutable one's inner index
    and counters included)."""
    arrays = {k: v for k, v in ref.arrays.items() if k != "main"}
    st = state_from_reference(ref.algo, ref.metric, arrays, ref.static,
                              device="cpu")
    if "main" not in ref.arrays:
        return st
    inner = ref.arrays["main"]
    st.arrays["main"] = state_from_reference(inner.algo, inner.metric,
                                             inner.arrays, inner.static,
                                             device="cpu")
    for name in ("count", "next_id"):
        st.arrays[name] = torch.tensor(int(ref.arrays[name]),
                                       dtype=torch.int32)
    return st


_STATES: dict = {}


@pytest.fixture(scope="module")
def shared_builds():
    with shared_graph_builds():
        yield


def _reference_state(name, request):
    if name not in _STATES:
        fixture, build_params, _, _ = SWEEP_CASES[name]
        ds = request.getfixturevalue(fixture)
        ref = jx_functional.get_functional(name).build(
            ds.train, metric=ds.metric, **build_params)
        if name == "MutableIVF":            # a churned state
            ref, _ = jx_mutate.insert(ref, ds.train[:5] + 0.5)
            ref = jx_mutate.delete(ref, [3, ds.train.shape[0]])
        _STATES[name] = (ref, _carry(ref), ds)
    return _STATES[name]


def _rows_agree(name, want, got):
    """[S, b, kk] sweeps: per row, differing queries counted (0 for
    EXACT algorithms, <= 5 % otherwise); the rest equal in ids and close
    in distances."""
    wd, wi = (np.asarray(a) for a in want)
    gd, gi = (a.numpy() for a in got)
    assert gi.shape == wi.shape, (gi.shape, wi.shape)
    for row in range(wi.shape[0]):
        differ = (gi[row] != wi[row]).any(axis=1)
        limit = 0 if name in EXACT else int(0.05 * wi.shape[1])
        assert differ.sum() <= limit, (name, row, int(differ.sum()))
        ok = ~differ
        np.testing.assert_allclose(gd[row][ok], wd[row][ok], rtol=RTOL,
                                   atol=ATOL)


# ------------------------------------------------------------ grid_combos

@pytest.mark.parametrize("grid", [
    {"n_probes": (1, 4, 12)},
    {"n_probes": (1, 4), "scan": (8, 16, 64)},
    {"probe": [1, 2], "trees": (2,), "radius": (0, 1, 2)},
])
def test_grid_combos_equal_reference(grid):
    assert functional.grid_combos(grid) == jx_functional.grid_combos(grid)


def test_grid_combos_rejects_an_empty_axis_like_the_reference():
    with pytest.raises(ValueError) as got:
        functional.grid_combos({"n_probes": (1, 2), "scan": ()})
    with pytest.raises(ValueError) as want:
        jx_functional.grid_combos({"n_probes": (1, 2), "scan": ()})
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------- search_sweep

@pytest.mark.parametrize("name", PORTED)
def test_search_sweep_equals_reference(name, request, shared_builds):
    _, _, values, extra = SWEEP_CASES[name]
    ref, st, ds = _reference_state(name, request)
    knob, _ = jx_functional.get_functional(name).traced_knobs[0]
    Q = ds.test[:NQ]
    want = jx_functional.search_sweep(ref, Q, k=K, knob_grid={knob: values},
                                      **extra)
    got = functional.search_sweep(st, Q, k=K, knob_grid={knob: values},
                                  **extra)
    _rows_agree(name, want, got)
    # each row is the port's own static search at that value
    spec = functional.get_functional(name)
    for row, v in enumerate(values):
        sd, si = spec.search(st, Q, k=K, **{knob: v}, **extra)
        w = si.shape[1]
        assert torch.equal(got[1][row][:, :w], si)
        assert (got[1][row][:, w:] == -1).all()


@pytest.mark.parametrize("name", sorted(MULTIKNOB_CASES))
def test_multiknob_search_sweep_equals_reference(name, request):
    grid = MULTIKNOB_CASES[name]
    ref, st, ds = _reference_state(name, request)
    Q = ds.test[:NQ]
    want = jx_functional.search_sweep(ref, Q, k=K, knob_grid=grid)
    got = functional.search_sweep(st, Q, k=K, knob_grid=grid)
    _rows_agree(name, want, got)


def test_search_sweep_rejects_what_the_reference_rejects(request):
    ref, st, ds = _reference_state("IVF", request)
    Q = ds.test[:4]
    for kw, match in (
            ({"knob_grid": {"n_probes": (1, 2)}, "n_probes": 2},
             "both the sweep grid and"),
            ({"knob_grid": {"n_probes": (1, 16)}, "max_probes": 8},
             "exceeds max_probes"),
            ({"knob_grid": {"n_probes": (1, 2), "scan": ()}},
             "at least one value"),
            ({"knob_grid": {"bogus": (1, 2)}}, "traced-cap")):
        with pytest.raises(Exception, match=match) as got:
            functional.search_sweep(st, Q, k=5, **kw)
        with pytest.raises(Exception, match=match) as want:
            jx_functional.search_sweep(ref, Q, k=5, **kw)
        assert type(got.value) is type(want.value)


# ---------------------------------------------------------- select / pareto

def _points(pkg, seed):
    rng = np.random.default_rng(seed)
    recall = np.round(rng.uniform(0.5, 1.0, 24), 2)       # ties on purpose
    qps = np.round(rng.uniform(100, 1000, 24), -2)
    return [pkg.OperatingPoint(
        params={"n_probes": int(1 + i % 6), "scan": int(8 << (i // 6))},
        recall=float(r), qps=float(q), latency=1.0 / float(q))
        for i, (r, q) in enumerate(zip(recall, qps))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("constraint", [
    ("min_recall", 0.8), ("min_recall", 0.95), ("min_recall", 1.1),
    ("max_latency", 2e-3), ("max_latency", 1e-4)])
def test_select_and_pareto_equal_reference(seed, constraint):
    how, bound = constraint
    got = tune.select(_points(tune, seed),
                      getattr(tune.Constraint, how)(bound))
    want = jx_tune.select(_points(jx_tune, seed),
                          getattr(jx_tune.Constraint, how)(bound))
    assert (got is None) == (want is None)
    if got is not None:
        assert got.params == want.params
    from repro.tune.tuner import _pareto_points as jx_pareto
    from repro_torch.tune.tuner import _pareto_points

    assert [p.params for p in _pareto_points(_points(tune, seed))] == \
        [p.params for p in jx_pareto(_points(jx_tune, seed))]


# ------------------------------------------------------------ grid_search

def test_grid_search_params_and_recalls_equal_reference(request):
    ref, st, ds = _reference_state("IVF", request)
    Q, gt = ds.test[:32], ds.distances[:32]
    grid = {"n_probes": (1, 4, 30), "scan": (8, st.stat("pad"))}
    constraint = (tune.Constraint.min_recall(0.9),
                  jx_tune.Constraint.min_recall(0.9))
    got = tune.grid_search(st, Q, gt, k=K, knob_grid=grid,
                           constraint=constraint[0], repetitions=1)
    want = jx_tune.grid_search(ref, Q, gt, k=K, knob_grid=grid,
                               constraint=constraint[1], repetitions=1)
    assert [p.params for p in got.points] == [p.params for p in want.points]
    for g, w in zip(got.points, want.points):
        assert abs(g.recall - w.recall) <= 1.0 / (len(Q) * K)
        assert g.qps > 0 and g.latency > 0
    assert got.best is not None and got.best.recall >= 0.9
    assert all(got.best.qps >= p.qps for p in got.points if p.recall >= 0.9)
    assert set(map(id, got.pareto)) <= set(map(id, got.points))


# ------------------------------------------------------------- launch.knobs

GOOD = [["n_probes=8"], ["n_probes=8", "max_probes=32"],
        ["ef=64,n_probes=8"], ["a=1,a=2"], ["x=1.5,y=true,z=False,w=abc"],
        ["quantize=pq,m=16,bits=8", "n_clusters=64"],
        ["quantize=int8"], ["n_clusters=64"]]
BAD_KV = [["n_probes"], ["=3"], ["a=1,,b=2"], ["ef=64,bogus"]]
BAD_BUILD = [["m=16"], ["quantize=pq,m=16,bits=9"], ["quantize=opq"],
             ["quantize=int8,m=4"], ["quantize=pq,bits=0"]]
GRIDS = [["n_probes=1,2,4", "scan=32,128"], ["ef=16"], ["radius=0,1.5,x"]]
BAD_GRIDS = [["n_probes"], ["=1,2"], ["n_probes="]]


@pytest.mark.parametrize("tokens", GOOD)
def test_knobs_parse_like_the_reference(tokens):
    assert knobs.parse_kv(tokens) == jx_knobs.parse_kv(tokens)
    assert knobs.parse_build(tokens) == jx_knobs.parse_build(tokens)
    params = knobs.parse_kv(tokens)
    assert knobs.format_kv(params) == jx_knobs.format_kv(params)
    for tok in ("3", "-2", "1.5", "1e3", "true", "True", "false", "abc", ""):
        assert knobs.coerce(tok) == jx_knobs.coerce(tok)
        assert type(knobs.coerce(tok)) is type(jx_knobs.coerce(tok))


def _exit_text(fn, tokens):
    with pytest.raises(SystemExit) as err:
        fn(tokens)
    return str(err.value)


@pytest.mark.parametrize("fn, tokens", [("parse_kv", t) for t in BAD_KV]
                         + [("parse_build", t) for t in BAD_BUILD]
                         + [("parse_grid", t) for t in BAD_GRIDS])
def test_knobs_refuse_with_the_references_messages(fn, tokens):
    assert _exit_text(getattr(knobs, fn), tokens) == \
        _exit_text(getattr(jx_knobs, fn), tokens)


@pytest.mark.parametrize("tokens", GRIDS)
def test_parse_grid_like_the_reference(tokens):
    assert knobs.parse_grid(tokens) == jx_knobs.parse_grid(tokens)


# ------------------------------------------------------------- launch.tune

@pytest.fixture()
def shared_cache(tmp_path, monkeypatch):
    """One dataset cache: the reference builds each file, the port loads
    it (the same data and ground truth)."""
    monkeypatch.setattr(jx_datasets, "DEFAULT_DATA_DIR", tmp_path)
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    return tmp_path


def test_launch_tune_json_equals_reference(shared_cache, capsys):
    from repro.launch import tune as jx_cli
    from repro_torch.launch import tune as cli

    args = ["--dataset", "blobs-euclidean-2000", "--algorithm", "RPForest",
            "--build", "n_trees=8,leaf_size=32", "--grid", "probe=1,4",
            "trees=4,8", "--nq", "32", "--repetitions", "1",
            "--min-recall", "0.5"]
    jx_cli.main(args + ["--out-json", str(shared_cache / "want.json")])
    result = cli.main(args + ["--out-json", str(shared_cache / "got.json"),
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[tune] chosen:" in out and result.best is not None
    got = json.loads((shared_cache / "got.json").read_text())
    want = json.loads((shared_cache / "want.json").read_text())
    assert set(got) == set(want)
    for key in ("dataset", "algorithm", "k", "constraint"):
        assert got[key] == want[key]
    assert [p["params"] for p in got["points"]] == \
        [p["params"] for p in want["points"]]
    for g, w in zip(got["points"], want["points"]):
        assert abs(g["recall"] - w["recall"]) <= 1.0 / (32 * K) + 1e-4


def test_launch_tune_refuses_like_the_reference():
    from repro.launch import tune as jx_cli
    from repro_torch.launch import tune as cli

    for args in (["--grid", "n_probes=1,2"],
                 ["--grid", "n_probes=1", "--min-recall", "0.9",
                  "--max-latency", "1e-3"]):
        assert _exit_text(cli.main, args + ["--device", "cpu"]) == \
            _exit_text(jx_cli.main, args)
