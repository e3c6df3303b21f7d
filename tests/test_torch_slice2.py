"""The second slice of the port as a whole: the Hamming algorithms and
quantized BruteForce through the port's ``run_benchmark`` (device ``cpu``),
held against the reference's ``run_benchmark`` records on the same
datasets (the reference builds and caches them, the port loads the cache).

Tolerances: Hamming neighbours bitwise (integer distances, (dist, id)
order everywhere); quantized BruteForce neighbours bitwise outside the
reference's near ties (adjacent recomputed distances within 1e-4), with
swaps at near ties counted and allowed (the ADC sums are reassociated);
recomputed distances rtol=1e-5, atol=1e-4.  The port scans with its ADC
kernel route (the plain version on the CPU), the reference with its XLA
fold: the two give the same ids outside near ties (test_torch_quant.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.ann  # noqa: E402,F401
import repro.data.datasets as jx_datasets  # noqa: E402
from repro.core.runner import run_benchmark as jx_run_benchmark  # noqa: E402
from repro_torch.core.metrics import recall  # noqa: E402
from repro_torch.core.runner import run_benchmark  # noqa: E402

PQ = {"pq": {"m": 8, "bits": 8}}


def config(adc_kernel: bool):
    return {
        "bit": {"hamming": {
            "bfh": {"constructor": "BruteForceHamming",
                    "base-args": ["@metric"],
                    "run-groups": {"kernel": {"args": ["pallas"]}}},
            "annoy": {"constructor": "BitsamplingAnnoy",
                      "base-args": ["@metric"],
                      "run-groups": {"kernel": {
                          "args": [4, 16, 0, False, None, True],
                          "query-args": [[1, 3, 6]]}}},
            "mih": {"constructor": "MultiIndexHashing",
                    "base-args": ["@metric"],
                    "run-groups": {"kernel": {
                        "args": [8, 64, 0, False, None, True],
                        "query-args": [[0, 1]]}}},
        }},
        "float": {"euclidean": {
            "bf_pq": {"constructor": "BruteForce", "base-args": ["@metric"],
                      "run-groups": {"adc": {
                          "args": ["jnp", 65536, False, 4096, PQ, True,
                                   adc_kernel],
                          "query-args": [[20, 100]]}}},
        }},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = tmp_path_factory.mktemp("data")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jx_datasets, "DEFAULT_DATA_DIR", data)
        mp.setenv("REPRO_DATA_DIR", str(data))
        for name in ("random-hamming-1500-b128", "blobs-euclidean-2000"):
            want = jx_run_benchmark(name, config(False), count=10,
                                    batch=True, verbose=False)
            got = run_benchmark(name, config(True), count=10, batch=True,
                                verbose=False, device="cpu")
            out[name] = (want, got)
    return out


def _records(runs, name, algo):
    want, got = runs[name]
    key = lambda r: r.query_arguments  # noqa: E731
    w = sorted((r for r in want if r.algorithm == algo), key=key)
    g = sorted((r for r in got if r.algorithm == algo), key=key)
    assert len(w) == len(g) > 0
    return list(zip(w, g))


@pytest.mark.parametrize("algo,n_groups", [("bfh", 1), ("annoy", 3),
                                           ("mih", 2)])
def test_hamming_algorithms_match_reference(runs, algo, n_groups):
    pairs = _records(runs, "random-hamming-1500-b128", algo)
    assert len(pairs) == n_groups
    rec = []
    for w, g in pairs:
        assert g.instance_name == w.instance_name
        assert g.query_arguments == w.query_arguments
        np.testing.assert_array_equal(g.neighbors, w.neighbors)
        np.testing.assert_array_equal(g.distances, w.distances)
        rec.append(recall(g))
    assert rec == sorted(rec)
    if algo == "bfh":
        assert rec == [1.0]


def test_quantized_bruteforce_matches_reference(runs):
    pairs = _records(runs, "blobs-euclidean-2000", "bf_pq")
    assert [g.query_arguments for _, g in pairs] == [(20,), (100,)]
    rec = []
    for w, g in pairs:
        assert g.instance_name == w.instance_name
        assert g.neighbors.shape == w.neighbors.shape
        bad = g.neighbors != w.neighbors
        near = np.zeros_like(bad)
        gap = np.abs(np.diff(w.distances, axis=1)) <= 1e-4
        near[:, 1:] |= gap
        near[:, :-1] |= gap
        assert int((bad & ~near).sum()) == 0
        np.testing.assert_allclose(np.sort(g.distances, axis=1),
                                   np.sort(w.distances, axis=1), rtol=1e-5,
                                   atol=1e-4)
        rec.append(recall(g))
    assert rec == sorted(rec) and rec[-1] >= 0.9
