"""The seven paper-figure benches of the port (``repro_torch.benchmarks.
bench_{recall_qps,index_size,robustness,approximation,hamming,build_time,
batch_mode}``) against the reference's ``benchmarks/`` modules.

Each figure runs in both packages in one process at n = 1,000 (the smoke
scale patched in both ``common`` modules), on one dataset cache: the
reference builds the file and the port loads it, so the data and the
ground truth are the same.  Required: the same row names in the same
order, each row's recall within 0.01 of the reference's (one neighbour of
the 100 that 10 queries return), fig5's ``index_kB`` equal and fig8's
eps-recalls within 0.01.  Times are each package's own and not compared.
fig4 and fig10 build KNNGraph and HNSW on the same points with the same
parameters: each package builds them once (``graph_build_cache``).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import benchmarks.common as jx_common  # noqa: E402
import repro.data.datasets as jx_datasets  # noqa: E402
from graph_build_cache import shared_graph_builds  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402

N = 1_000
FIGURES = {"fig4": "bench_recall_qps", "fig5": "bench_index_size",
           "fig6": "bench_robustness", "fig8": "bench_approximation",
           "fig9": "bench_hamming", "fig10": "bench_build_time",
           "fig11": "bench_batch_mode"}
EXACT = ("index_kB",)
WITHIN = {"recall": 0.01, "eps0.01": 0.01, "eps0.1": 0.01}


@pytest.fixture(scope="module")
def shared_builds():
    with shared_graph_builds():
        yield


def _derived(row):
    return dict(kv.split("=") for kv in row.derived.split(";") if kv)


@pytest.mark.parametrize("fig", sorted(FIGURES))
def test_figure_rows_match_reference(fig, tmp_path, monkeypatch,
                                     shared_builds):
    monkeypatch.setitem(jx_common.SCALES, "smoke", N)
    monkeypatch.setitem(common.SCALES, "smoke", N)
    monkeypatch.setattr(jx_datasets, "DEFAULT_DATA_DIR", tmp_path)
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    name = FIGURES[fig]
    want = importlib.import_module(f"benchmarks.{name}").run("smoke")
    got = importlib.import_module(
        f"repro_torch.benchmarks.{name}").run("smoke", "cpu")
    assert [r.name for r in got] == [r.name for r in want]
    assert want
    for g, w in zip(got, want):
        gd, wd = _derived(g), _derived(w)
        assert "recall" in gd and set(gd) == set(wd), (g, w)
        for key in EXACT:
            if key in wd:
                assert gd[key] == wd[key], (g, w)
        for key, tol in WITHIN.items():
            if key in wd:
                assert abs(float(gd[key]) - float(wd[key])) <= tol + 1e-9, \
                    (g, w)
        assert np.isfinite(g.us_per_call) and g.us_per_call > 0
