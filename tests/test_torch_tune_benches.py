"""The port's sweep / tuner / compressed-domain / serving benches
(``repro_torch.benchmarks.bench_{sweep,tune,pq,engine}``) at ``smoke`` on
the CPU against the reference's ``benchmarks/`` modules: the reference's
row names and non-timing fields.  Times are each package's own and not
compared; ``bench_sweep`` and ``bench_tune`` print no other field a
package's timings do not decide, so their rows are held to the
reference's configuration (``SWEEPS``, ``GRIDS``, ``NQ``) without running
it, and ``bench_pq`` runs in both packages on one dataset cache.
``bench_engine``'s rows are held to the reference's names, request draws
(``_draw``) and padding, also without running it (its jittered rows time
the reference's retraces).
"""

import pytest

torch = pytest.importorskip("torch")

import repro.data.datasets as jx_datasets  # noqa: E402
from repro.ann import functional as jx_functional  # noqa: E402


@pytest.fixture()
def shared_cache(tmp_path, monkeypatch):
    """One dataset cache: the reference builds each file, the port loads
    it (the same data and ground truth)."""
    monkeypatch.setattr(jx_datasets, "DEFAULT_DATA_DIR", tmp_path)
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    return tmp_path


def _derived(row):
    return dict(kv.split("=", 1) for kv in row.derived.split(";") if kv)


def test_bench_sweep_rows_match_reference(shared_cache):
    """The reference's row names (from its ``SWEEPS``, without running it:
    its timings are its own) and non-timing fields."""
    from benchmarks import bench_sweep as jx_bench
    from repro_torch.benchmarks import bench_sweep

    got = bench_sweep.run("smoke", "cpu")
    want = []
    for name, (_, values) in jx_bench.SWEEPS.items():
        knob = jx_functional.get_functional(name).traced_knobs[0][0]
        want += [f"sweep/{name}/{path}/{knob}x{len(values)}"
                 for path in ("per_group_retrace", "traced_cap",
                              "search_sweep")]
    assert [r.name for r in got] == want
    assert bench_sweep.SWEEPS == jx_bench.SWEEPS
    for row in got:
        derived = _derived(row)
        if "per_group_retrace" in row.name:
            assert derived == {"nq": str(jx_bench.NQ)}
        else:
            assert derived["equal_recall"] == "True"


def test_bench_tune_rows_match_reference(shared_cache):
    """The reference's row names (from its ``GRIDS``) and non-timing
    fields; the tuner gate's chosen point depends on each package's own
    timings, so only its floor, gate and feasibility are compared."""
    from benchmarks import bench_tune as jx_bench
    from repro_torch.benchmarks import bench_tune

    got = bench_tune.run("smoke", "cpu")
    want = []
    for name, (_, grid) in jx_bench.GRIDS.items():
        shape = "x".join(str(len(v)) for v in grid.values())
        gridname = f"{'+'.join(grid)}[{shape}]"
        want += [f"tune/{name}/per_combo_retrace/{gridname}",
                 f"tune/{name}/grid_sweep/{gridname}"]
    assert [r.name for r in got] == want + ["tune/IVF/grid_search"]
    assert bench_tune.GRIDS == jx_bench.GRIDS
    for row in got[:-1]:
        derived = _derived(row)
        if "per_combo_retrace" in row.name:
            assert derived == {"nq": str(jx_bench.NQ)}
        else:
            assert derived["equal_recall"] == "True"
    gate = _derived(got[-1])
    assert gate["floor"] == "0.9" and gate["gate"] == "pass"
    assert float(gate["recall"]) >= float(gate["floor"])


def test_bench_pq_summary_matches_reference(shared_cache, monkeypatch):
    from benchmarks import bench_pq as jx_bench
    from repro_torch.benchmarks import bench_pq

    monkeypatch.setattr(jx_functional, "_SWEEP_FNS", {})
    want_rows, want = jx_bench.run_with_summary("smoke")
    got_rows, got = bench_pq.run_with_summary("smoke", "cpu")
    assert [r.name for r in got_rows] == [r.name for r in want_rows]
    assert got["shape"] == want["shape"]
    assert got["fp32_bytes_per_vec"] == want["fp32_bytes_per_vec"]
    assert got["kernel_ids_bitwise"] and want["kernel_ids_bitwise"]
    for codec in ("pq_m16_b8", "int8"):
        g, w = got[codec], want[codec]
        for key in ("bytes_per_vec", "ratio", "equal_recall_n_cand"):
            assert g[key] == w[key], (codec, key)
        assert set(g["recall_curve"]) == set(w["recall_curve"])
        for v, r in w["recall_curve"].items():
            assert abs(g["recall_curve"][v] - r) <= 0.01, (codec, v)
    kernel = _derived(got_rows[-1])
    assert kernel["device"] == "cpu" and kernel["parity"] == "ids_bitwise"
    assert kernel["b"] == _derived(want_rows[-1])["b"]


def test_bench_engine_rows_match_reference(shared_cache, monkeypatch):
    """The reference's row names, equal recall across the two paths, and
    the Engine's padded rows counted from the reference's own request
    draws: the warm-up, the jittered stream and the fixed stream pad each
    request up to whole micro-batches of ``BATCH``.  The timed streams
    are cut to two requests each (the rows and draws are those of the
    reference's run at that length).  Without a card and without
    ``"cpu"`` it raises before building anything."""
    import numpy as np
    from benchmarks import bench_engine as jx_bench
    from repro_torch.benchmarks import bench_engine

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_engine.run("smoke")
    assert (bench_engine.K, bench_engine.BATCH, bench_engine.N_REQUESTS) \
        == (jx_bench.K, jx_bench.BATCH, jx_bench.N_REQUESTS)
    n_requests = 2
    monkeypatch.setattr(bench_engine, "N_REQUESTS", n_requests)
    got = bench_engine.run("smoke", "cpu")
    assert [r.name for r in got] == [
        f"serve/{w}/{p}" for w in ("jittered", "fixed")
        for p in ("legacy_batch_query_loop", "engine_micro_batched",
                  "engine_speedup")]
    rows = {r.name: _derived(r) for r in got}
    for w in ("jittered", "fixed"):
        assert rows[f"serve/{w}/legacy_batch_query_loop"]["recall"] \
            == rows[f"serve/{w}/engine_micro_batched"]["recall"]
        assert rows[f"serve/{w}/engine_speedup"]["equal_recall"] == "True"
        assert float(rows[f"serve/{w}/engine_micro_batched"]["recall"]) \
            >= 0.9

    from types import SimpleNamespace

    from repro_torch.benchmarks.common import dataset_size

    # request sizes are drawn before any row, so any test set will do
    ds = SimpleNamespace(test=np.zeros((dataset_size("smoke"), 1)))
    warm = jx_bench._draw(ds, np.random.default_rng(0), 4)[1]
    jittered = jx_bench._draw(ds, np.random.default_rng(1), n_requests)[1]
    want = sum(-len(q) % jx_bench.BATCH for q in warm + jittered)
    assert rows["serve/fixed/engine_micro_batched"]["padded"] == str(want)
