"""The first slice of the port as a whole: dataset -> build -> batch and
single query -> RunRecord -> recall, with BruteForce and IVF, held against
the JAX package on the same arrays.

Both packages build the datasets in this process, so ``hash(name)`` seeds
them alike (Python randomizes it per process) and they must come out
bitwise identical.  The other tests pin the seed, so that their data (and
its near ties) is the same in every run.

Tolerances: float distances rtol=1e-5, atol=1e-4; ids bitwise except at
the reference's near ties (adjacent distances within atol), counted and
expected to be 0 -- except in the deep tail (ranks 11-100) of the ground
truth, where such ties exist; port-built IVF recall within 0.01 of the
reference's (k-means sums in another order).
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.ann  # noqa: E402,F401
from repro.ann import ivf as jx_ivf  # noqa: E402
from repro.core import experiment as jx_exp  # noqa: E402
from repro.core.config import get_definitions as jx_definitions  # noqa: E402
from repro.data import synthetic as jx_synth  # noqa: E402
from repro_torch.ann import ivf  # noqa: E402
from repro_torch.ann.functional import search_sweep_points  # noqa: E402
from repro_torch.convert import state_from_reference  # noqa: E402
from repro_torch.core import experiment  # noqa: E402
from repro_torch.core import results  # noqa: E402
from repro_torch.core.config import get_definitions  # noqa: E402
from repro_torch.core.metrics import recall  # noqa: E402
from repro_torch.core.runner import run_benchmark  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
NAMES = {"euclidean": "blobs-euclidean-2000", "angular": "blobs-angular-2000"}


def config():
    algos = {
        "bruteforce": {"constructor": "BruteForce", "base-args": ["@metric"],
                       "run-groups": {"kernel": {"args": ["pallas"]}}},
        "ivf": {"constructor": "IVF", "base-args": ["@metric"],
                "run-groups": {"kernel": {
                    "args": [32, 10, 0, False, None, True],
                    "query-args": [[1, 5, 20]]}}},
    }
    return {"float": {"euclidean": algos, "angular": algos}}


def _fixed_seed(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


@pytest.fixture(scope="module")
def datasets():
    """(reference, port) datasets per metric, built in this process with the
    builders' ``_seed`` pinned to a hash that does not change per process,
    so that every run draws the same data."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jx_synth, "_seed", _fixed_seed)
        mp.setattr(synthetic, "_seed", _fixed_seed)
        for metric, name in NAMES.items():
            ref = jx_synth.blobs(name=name, metric=metric, n=2000)
            port = synthetic.blobs(name=name, metric=metric, n=2000,
                                   device="cpu")
            out[metric] = (ref, port)
    return out


def assert_same_ids(want_d, want_i, got_i, atol=ATOL, near_ties_ok=False):
    """ids bitwise outside the reference's near ties; mismatches at near
    ties are counted and must be 0 unless ``near_ties_ok``.  Returns that
    count."""
    want_d, want_i, got_i = (np.asarray(a) for a in (want_d, want_i, got_i))
    assert want_i.shape == got_i.shape
    bad = want_i != got_i
    near = np.zeros_like(bad)
    gap = np.abs(np.diff(want_d, axis=1)) <= atol
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert int((bad & ~near).sum()) == 0, "id mismatches outside near ties"
    at_ties = int((bad & near).sum())
    assert near_ties_ok or at_ties == 0, "id mismatches at near ties"
    return at_ties


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_datasets_identical(datasets, metric):
    """With the real per-process ``hash(name)`` seed, both packages draw the
    same arrays in one process; ground truth is checked on pinned data."""
    name = NAMES[metric]
    ref = jx_synth.blobs(name=name, metric=metric, n=2000)
    port = synthetic.blobs(name=name, metric=metric, n=2000, device="cpu")
    np.testing.assert_array_equal(port.train, ref.train)
    np.testing.assert_array_equal(port.test, ref.test)
    ref, port = datasets[metric]
    assert port.name == ref.name and port.metric == ref.metric
    np.testing.assert_array_equal(port.train, ref.train)
    np.testing.assert_array_equal(port.test, ref.test)
    np.testing.assert_allclose(port.distances, ref.distances, rtol=RTOL,
                               atol=ATOL)
    # the k = 10 the benchmark reads: no near-tie swap expected
    assert_same_ids(ref.distances[:, :10], ref.neighbors[:, :10],
                    port.neighbors[:, :10])
    # all k = 100: the deep tail of a 2,000-point set has genuine near
    # ties, where the two matmuls' last bits may order a pair either way
    assert_same_ids(ref.distances, ref.neighbors, port.neighbors,
                    near_ties_ok=True)


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("batch", [True, False])
def test_bruteforce_loop_matches_reference(datasets, metric, batch):
    ref_ds, port_ds = datasets[metric]
    kw = dict(metric=metric, dimension=ref_ds.dimension, count=10,
              algorithms=["bruteforce"])
    want = jx_exp.run_definition(
        jx_definitions(config(), **kw)[0], ref_ds,
        jx_exp.ExperimentSettings(count=10, batch_mode=True))[0]
    got = experiment.run_definition(
        get_definitions(config(), **kw)[0], port_ds,
        experiment.ExperimentSettings(count=10, batch_mode=batch,
                                      device="cpu"))[0]
    assert got.batch_mode == batch and got.instance_name == want.instance_name
    assert recall(got) == 1.0
    assert_same_ids(ref_ds.distances[:, :10], want.neighbors, got.neighbors)
    np.testing.assert_allclose(got.distances, want.distances, rtol=RTOL,
                               atol=ATOL)
    assert got.query_times.size == (0 if batch else port_ds.test.shape[0])


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("rerank_kernel", [False, True])
def test_ivf_on_reference_state_same_ids(datasets, metric, rerank_kernel):
    """IVF built by the reference, carried over, searched by the port."""
    ref_ds, _ = datasets[metric]
    ref = jx_ivf.build(ref_ds.train, metric=metric, n_clusters=32)
    static = dict(ref.static, rerank_kernel=rerank_kernel)
    st = state_from_reference("IVF", ref.metric,
                              {k: np.asarray(v) for k, v in ref.arrays.items()},
                              static, device="cpu")
    Q = ref_ds.test
    for n_probes in (1, 5, 20):
        wd, wi = jx_ivf.search(ref, jnp.asarray(Q), k=10, n_probes=n_probes)
        gd, gi = ivf.search(st, Q, k=10, n_probes=n_probes)
        assert_same_ids(wd, wi, gi)
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=RTOL,
                                   atol=ATOL)
    # the grid path: one window at the cap, a mask per point
    sd, si = search_sweep_points(st, Q, k=10, points=[{"n_probes": p}
                                                      for p in (1, 5, 20)])
    assert si.shape == (3, Q.shape[0], 10)
    for row, n_probes in enumerate((1, 5, 20)):
        gd, gi = ivf.search(st, Q, k=10, n_probes=n_probes)
        assert torch.equal(si[row], gi)


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_port_built_ivf_recall_close_to_reference(datasets, metric):
    ref_ds, port_ds = datasets[metric]
    kw = dict(metric=metric, dimension=ref_ds.dimension, count=10,
              algorithms=["ivf"])
    want = jx_exp.run_definition(
        jx_definitions(config(), **kw)[0], ref_ds,
        jx_exp.ExperimentSettings(count=10, batch_mode=True))
    got = experiment.run_definition(
        get_definitions(config(), **kw)[0], port_ds,
        experiment.ExperimentSettings(count=10, batch_mode=True,
                                      device="cpu"))
    assert [r.query_arguments for r in got] == [(1,), (5,), (20,)]
    from repro.core.metrics import recall as jx_recall

    for w, g in zip(want, got):
        assert abs(recall(g) - jx_recall(w)) <= 0.01
    rec = [recall(g) for g in got]
    assert rec == sorted(rec)


def test_runner_stores_every_run(tmp_path, monkeypatch):
    """The runner CLI path on the CPU: dataset built here, every definition
    gives its records, each record round-trips through the results store."""
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path / "data"))
    records = run_benchmark("blobs-euclidean-2000", config(), count=10,
                            batch=True, out_dir=str(tmp_path / "res"),
                            verbose=False, device="cpu")
    assert sorted((r.algorithm, r.query_arguments) for r in records) == [
        ("bruteforce", ()), ("ivf", (1,)), ("ivf", (5,)), ("ivf", (20,))]
    stored = results.load_all(tmp_path / "res")
    assert len(stored) == 4
    bf = next(r for r in stored if r.algorithm == "bruteforce")
    assert recall(bf) == 1.0
