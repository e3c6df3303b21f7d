"""The port's serving launcher (``repro_torch.launch.serve``) against the
JAX package's ``repro.launch.serve``.

  * The knob parser is one object across the port's launchers, and its
    texts are the reference's (``tests/test_serving.py``'s knob cases).
  * ``main(..., "--device", "cpu")`` in each of the three modes prints the
    reference CLI's recall.  Both CLIs serve one index: the reference
    builds it and writes ``--index-cache``, the port restores that file,
    and both read one dataset cache.  The churn's recall counts ids
    against a float32 oracle over the live rows, so a query with a near
    tie at the k-th place may move it by one id in either CLI; the test
    counts such queries and holds every other one equal.
  * ``--shards N`` serves the sharded variant on N logical devices; above
    the logical device count it stops with the reference's text.

No test sleeps: the stream mode's Poisson gaps are made negligible with a
high ``--rate``.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.data.datasets as jx_datasets  # noqa: E402
from repro.launch import serve as jx_serve  # noqa: E402
from repro_torch.launch import knobs, serve, tune  # noqa: E402

DATASET = "blobs-euclidean-2000"
K = 10


@pytest.fixture()
def shared_cache(tmp_path, monkeypatch):
    """One dataset cache: the reference builds each file, the port loads
    it (the same data and ground truth)."""
    monkeypatch.setattr(jx_datasets, "DEFAULT_DATA_DIR", tmp_path)
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    return tmp_path


# --------------------------------------------------------------------------
# the shared knob parser
# --------------------------------------------------------------------------

def test_knobs_shared_across_launchers():
    """serve and tune parse knob strings through the SAME functions."""
    assert serve.parse_kv is knobs.parse_kv
    assert tune.parse_kv is knobs.parse_kv
    assert tune.parse_grid is knobs.parse_grid
    assert serve._kv is knobs.parse_kv
    assert serve._coerce is knobs.coerce
    assert serve.parse_build is knobs.parse_build
    assert tune.parse_build is knobs.parse_build


@pytest.mark.parametrize("tokens", [["quantize=zstd,m=16"],
                                    ["m=16,bits=8"], ["quantize=int8,m=4"],
                                    ["quantize=pq,bits=12"], ["oops"]])
def test_quantize_cli_error_identical_across_launchers(tokens):
    """The message reaching a serve operator and a tune operator is one
    text, and the reference serve launcher's."""
    msgs = []
    for mod in (serve, tune, jx_serve):
        with pytest.raises(SystemExit) as exc:
            mod.parse_build(tokens)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == msgs[2]


def test_knob_values_equal_reference():
    for tokens in (["ef=64,n_probes=8,frac=0.5,name=ivf,flag=true"],
                   ["a=1", "a=2"], ["quantize=pq,m=8,bits=6",
                                    "n_clusters=50"]):
        assert serve.parse_build(tokens) == jx_serve.parse_build(tokens)
        assert serve._kv(tokens) == jx_serve._kv(tokens)
    for token in ("16", "1.5", "true", "False", "no"):
        assert serve._coerce(token) == jx_serve._coerce(token)


# --------------------------------------------------------------------------
# the CLI in its three modes
# --------------------------------------------------------------------------

def _recall(text):
    """The aggregate recall a CLI printed last."""
    return re.findall(r"recall@\d+ = ([0-9.]+|nan)", text)[-1]


MODES = {
    "batch": ["--algorithm", "IVF", "--build", "n_clusters=16",
              "--query", "n_probes=4", "--n-batches", "2",
              "--batch-size", "64"],
    "stream": ["--algorithm", "IVF", "--build", "n_clusters=16",
               "--query", "n_probes=4", "--batch-size", "32",
               "--n-requests", "96", "--rate", "1e9",
               "--max-wait-ms", "1"],
    "churn": ["--algorithm", "MutableIVF",
              "--build", "n_clusters=16,delta_capacity=64",
              "--query", "n_probes=4", "--n-batches", "3",
              "--batch-size", "32", "--churn-inserts", "8"],
}


def _churn_boundary_ties(cache):
    """Per churn iteration, the queries whose k-th and (k+1)-th rows are
    a near tie: in float64 over the live rows (the oracle's cut), or in
    the port's own answer at k + 1 (the search's cut).  The churn's recall
    counts ids (the reference's definition), and either CLI's float32
    oracle or the reference's search (whose copies of a row do not tie
    exactly, ROADMAP §3) may put either row of such a pair at the k-th
    place; every other query must agree.  The churn is replayed on the
    port's Engine with the CLI's draws."""
    from repro_torch import mutate
    from repro_torch.data import get_dataset
    from repro_torch.serve import Engine

    ds = get_dataset(DATASET, device="cpu")
    eng = Engine.load(cache, device="cpu", k=11, batch_size=32)
    eng.query_params.update({"n_probes": 4})
    rng = np.random.default_rng(0)
    pending, ties = [], []
    for _ in range(3):
        rows = ds.train[rng.integers(0, len(ds.train), 8)]
        pending.append(np.asarray(eng.insert(rows)))
        if len(pending) > 2:
            eng.delete(pending.pop(0))
        Q = ds.test[rng.integers(0, len(ds.test), 32)].astype(np.float64)
        d, _ = eng.search(Q.astype(np.float32))
        _, X = mutate.live_items(eng.state)
        X = X.astype(np.float64)
        d64 = np.sort(((X[None] - Q[:, None]) ** 2).sum(-1), axis=1)
        # a float32 ||q||^2 - 2<q, x> + ||x||^2 is good to a few ulps of
        # the norms: 16 of them
        tol = 16 * 2.0 ** -23 * ((Q ** 2).sum(1) + (X ** 2).sum(1).max())
        tied = (np.abs(d64[:, K] - d64[:, K - 1]) < tol) \
            | (np.abs(d[:, K] - d[:, K - 1]) < tol)
        ties.append(int(tied.sum()))
    return ties


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_recall_equals_reference(mode, shared_cache, capsys):
    """The printed recall equals the reference CLI's.  In churn mode, per
    iteration, equal where no query meets a near tie at the k-th place;
    with ties, within one id per tied query (``_churn_boundary_ties``)."""
    cache = str(shared_cache / f"{mode}.ckpt")
    argv = ["--dataset", DATASET, "--mode", mode, "--index-cache", cache] \
        + MODES[mode]
    jx_serve.main(argv)
    want = capsys.readouterr().out
    assert "[serve] checkpointed to" in want
    agg = serve.main(argv + ["--device", "cpu", "--assert-recall", "0.9"])
    got = capsys.readouterr().out
    assert "[serve] restored" in got
    assert _recall(got) == f"{agg:.3f}" and agg >= 0.9
    if mode != "churn":
        assert _recall(got) == _recall(want)
    else:
        ties = _churn_boundary_ties(cache)
        per = [re.findall(r"churn \d+: .* recall@10 = ([0-9.]+)", text)
               for text in (got, want)]
        assert len(per[0]) == len(per[1]) == len(ties) == 3
        for g, w, t in zip(*per, ties):
            assert g == w if t == 0 else \
                abs(float(g) - float(w)) <= t / (32 * K) + 1e-3, (g, w, t)
        if not any(ties):
            assert _recall(got) == _recall(want)
        assert abs(float(_recall(got)) - float(_recall(want))) \
            <= np.mean(ties) / (32 * K) + 1e-3
    if mode == "stream":
        assert "answered 96/96 (timed out 0, rejected 0, failed 0" in got
        assert "latency ms: p50=" in got


def test_cli_refuses_shards_and_frozen_churn(shared_cache, capsys):
    """``--shards`` above the logical device count stops with the
    reference's text (one device in both packages here); on 2 logical
    devices ``--shards 2`` serves ShardedIVF, also with a fault plan in
    stream mode; a frozen algorithm's churn is refused."""
    from repro_torch.dist.mesh import force_device_count

    shards = ["--dataset", DATASET, "--build", "n_clusters=8", "--query",
              "n_probes=8", "--shards", "2", "--batch-size", "8"]
    with pytest.raises(SystemExit) as exc:
        serve.main(shards + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jexc:
        jx_serve.main(shards)
    assert str(exc.value) == str(jexc.value)
    assert "--shards 2 needs 2 devices but only 1 are visible" \
        in str(exc.value)
    prev = force_device_count(2)
    try:
        capsys.readouterr()
        agg = serve.main(shards + ["--n-batches", "2", "--device", "cpu"])
        assert "built ShardedIVF index" in capsys.readouterr().out
        assert agg == 1.0                    # every list probed: exact
        serve.main(shards + ["--mode", "stream", "--n-requests", "48",
                             "--rate", "1e6", "--faults",
                             "seed=1,shard_drop=0.5", "--device", "cpu"])
        out = capsys.readouterr().out
        assert re.search(r"answered \d+/48 \(timed out 0, rejected 0, "
                         r"failed 0, degraded [1-9]\d*\)", out), out
        assert "chaos: retried=0 coverage p5=" in out
        with pytest.raises(SystemExit, match="no sharded variant of HNSW"):
            serve.main(["--dataset", DATASET, "--algorithm", "HNSW",
                        "--shards", "2", "--device", "cpu"])
    finally:
        force_device_count(prev)
    argv = ["--dataset", DATASET, "--build", "n_clusters=8", "--mode",
            "churn", "--n-batches", "1", "--batch-size", "8"]
    with pytest.raises(SystemExit) as exc:
        serve.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jexc:
        jx_serve.main(argv)
    assert str(exc.value) == str(jexc.value)
    assert "needs a mutable algorithm" in str(exc.value)
