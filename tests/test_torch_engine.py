"""The port's synchronous serving engine (``repro_torch.serve.engine``) and
checkpoints (``repro_torch.serve.checkpoint``) against the JAX package's:
the behaviours of ``tests/test_engine.py``, and checkpoint files that
load in both packages, both ways.

The port serves the same state as the reference (a reference-written file
loaded in the port, or the other way round), so both engines search equal
arrays.  Rows are small-integer grids wherever answers are compared, so
every euclidean distance is exact: ids bitwise and distances equal.  The
angular MutableBruteForce case scans in float64 dots rounded once in the
port (``bruteforce.exact_angular``) and in float32 in the reference: ids
bitwise, distances (1 - cos) within ``ANGULAR_ATOL``, two float32 ulps
of 1.0, the size of the reference's rounding of the cosine.  The recall gate runs on
the blobs set of ``tests/test_engine.py`` in each package's own build:
each at recall >= 0.9, the two within 0.01 (k-means sums in another
order).  Error texts must equal the reference's with the path replaced.
No test waits on the clock: deadlines are already expired or read at a
given ``now``, and background compactions are joined.
"""

import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import mutate as jx_mutate  # noqa: E402
from repro.ann import bruteforce as jx_bf  # noqa: E402
from repro.ann import hnsw as jx_hnsw  # noqa: E402
from repro.ann import ivf as jx_ivf  # noqa: E402
from repro.ann import lsh as jx_lsh  # noqa: E402
from repro.serve import Engine as JxEngine  # noqa: E402
from repro.serve import checkpoint as jx_ckpt  # noqa: E402
from repro_torch import mutate  # noqa: E402
from repro_torch.ann import bruteforce, hnsw, ivf, lsh  # noqa: E402
from repro_torch.serve import (CHECKPOINT_VERSION, CheckpointError,  # noqa: E402
                               DeadlineExceeded, Engine, checkpoint)
from repro_torch.serve.engine import load_state, save_state  # noqa: E402

ANGULAR_ATOL = 2.0 ** -22
K = 10


def _grid(rng, m, d):
    return rng.integers(-8, 8, size=(m, d)).astype(np.float32)


def assert_same(got, want, atol=0.0):
    """``got`` (the port's numpy pair) against ``want`` (the reference's):
    ids bitwise, distances equal or within ``atol``."""
    gd, gi = (np.asarray(a) for a in got)
    wd, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    if atol:
        np.testing.assert_allclose(gd, wd, rtol=0.0, atol=atol)
    else:
        np.testing.assert_array_equal(gd, wd)


def same_error(port_exc, jx_exc, port_path, jx_path):
    """The two packages' error texts, equal with the paths replaced."""
    def text(e, path):
        return str(e.value).replace(str(path), "<path>")
    assert type(port_exc.value).__name__ == type(jx_exc.value).__name__
    assert text(port_exc, port_path) == text(jx_exc, jx_path)


def npz_members(path):
    """{member: (dtype, shape, bytes)} of a single-state file, and its
    metadata record."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__repro_meta__"].tobytes()).decode())
        arrays = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                  for k in z.files if k != "__repro_meta__"}
    return arrays, meta


# --------------------------------------------------------------------------
# one IVF state served by both packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid_data():
    rng = np.random.default_rng(21)
    return _grid(rng, 600, 12), _grid(rng, 40, 12)


@pytest.fixture(scope="module")
def ivf_pair(grid_data, tmp_path_factory):
    """(reference state, the port's copy of it through a reference-written
    file): IVF with 30 lists."""
    X, _ = grid_data
    jst = jx_ivf.build(X, metric="euclidean", n_clusters=30)
    path = tmp_path_factory.mktemp("ivf") / "ivf.ckpt"
    jx_ckpt.save(path, jst)
    st, _ = checkpoint.load(path, device="cpu").only
    return jst, st


def _engines(ivf_pair, **kw):
    jst, st = ivf_pair
    kw.setdefault("k", K)
    kw.setdefault("batch_size", 16)
    return JxEngine(jst, **kw), Engine(st, **kw)


def test_micro_batching_matches_direct_search(ivf_pair, grid_data):
    """Padded fixed-shape micro-batches must not change results, for any
    request size, and answer as the reference's engine does."""
    _, Q = grid_data
    jeng, eng = _engines(ivf_pair, query_params={"n_probes": 8})
    for nq in (1, 7, 16, 19):
        got = eng.search(Q[:nq])
        assert got[1].shape == (nq, K) and got[1].dtype == np.int32
        want_d, want_i = ivf.search(eng.state, Q[:nq], k=K, n_probes=8)
        assert_same(got, (want_d.numpy(), want_i.numpy()))
        assert_same(got, jeng.search(Q[:nq]))
    dists, ids = eng.search(Q[:0])
    assert dists.shape == (0, K) and ids.shape == (0, K)
    assert eng.stats["padded"] == jeng.stats["padded"] > 0
    assert eng.stats["queries"] == 43 and eng.stats["batches"] == 5


def test_read_tickets_leave_the_engine(ivf_pair, grid_data):
    """An answered ticket waits in the engine for the deprecated
    ``Engine.result`` only until ``ticket.result()`` reads it, so a caller
    on the ticket API leaves nothing behind; the ticket keeps its
    answer, and an expired ticket's error is let go the same way."""
    _, Q = grid_data
    _, eng = _engines(ivf_pair, query_params={"n_probes": 8})
    tickets = [eng.submit(q) for q in Q[:20]]
    late = eng.submit(Q[20], deadline_ms=-1.0)
    eng.flush()
    assert len(eng._results) == 21
    answers = [t.result() for t in tickets]
    with pytest.raises(DeadlineExceeded):
        late.result()
    assert eng._results == {}
    _, want = eng.search(Q[:20])
    np.testing.assert_array_equal(np.stack([a[1] for a in answers]), want)
    assert_same(tickets[0].result(), answers[0])
    with pytest.raises(KeyError), pytest.warns(DeprecationWarning):
        eng.result(tickets[0])


def test_submit_flush_ticket_stream(ivf_pair, grid_data):
    _, Q = grid_data
    jeng, eng = _engines(ivf_pair, query_params={"n_probes": 8})
    tickets = [eng.submit(q) for q in Q[:5]]
    jtickets = [jeng.submit(q) for q in Q[:5]]
    eng.flush()
    jeng.flush()
    _, batch_ids = eng.search(Q[:5])
    for i, (t, jt) in enumerate(zip(tickets, jtickets)):
        assert t.done()
        with pytest.warns(DeprecationWarning):
            dists, ids = eng.result(t)
        np.testing.assert_array_equal(ids, batch_ids[i])
        assert_same((dists, ids), jt.result())
        assert_same(t.result(), (dists, ids))
    with pytest.raises(KeyError), pytest.warns(DeprecationWarning):
        eng.result(tickets[0])           # tickets are single-use


def test_full_batch_flushes_on_submit(ivf_pair, grid_data):
    """The 16th submit fills the micro-batch and answers it at once."""
    _, Q = grid_data
    _, eng = _engines(ivf_pair, query_params={"n_probes": 8})
    tickets = [eng.submit(q) for q in Q[:16]]
    assert all(t.done() for t in tickets) and eng.stats["batches"] == 1
    assert eng.stats["padded"] == 0


def test_deadline_expired_ticket_fails_alone(ivf_pair, grid_data):
    """A request whose deadline has already passed is answered with
    DeadlineExceeded, and the rest of its micro-batch is answered."""
    _, Q = grid_data
    jeng, eng = _engines(ivf_pair, query_params={"n_probes": 8})
    ok1 = eng.submit(Q[0])
    late = eng.submit(Q[1], deadline_ms=-1.0)
    ok2 = eng.submit(Q[2], deadline_ms=1e9)
    assert late.expired() and not ok2.expired()
    assert ok2.expired(now=ok2._submitted + 1e7)
    assert not ok2.expired(now=ok2._submitted + 1e5)
    with pytest.raises(DeadlineExceeded, match="missed its -1.0 ms "
                                               "deadline"):
        late.result()
    assert isinstance(late._error, TimeoutError)
    want = jeng.search(Q[:3])
    assert_same(ok1.result(), (want[0][0], want[1][0]))
    assert_same(ok2.result(), (want[0][2], want[1][2]))
    assert eng.stats["queries"] == 2


def test_checkpoint_roundtrip_identical(ivf_pair, grid_data, tmp_path):
    _, Q = grid_data
    _, eng = _engines(ivf_pair, query_params={"n_probes": 8})
    path = tmp_path / "ivf.ckpt"
    eng.save(path)
    restored = Engine.load(path, device="cpu")
    assert restored.k == eng.k
    assert restored.batch_size == eng.batch_size
    assert restored.query_params["n_probes"] == 8
    assert_same(restored.search(Q), eng.search(Q))


def test_checkpoint_rejects_stale_version(ivf_pair, tmp_path, monkeypatch):
    jeng, eng = _engines(ivf_pair)
    path, jpath = tmp_path / "stale.ckpt", tmp_path / "jx_stale.ckpt"
    monkeypatch.setattr(checkpoint, "CHECKPOINT_VERSION",
                        CHECKPOINT_VERSION + 1)
    monkeypatch.setattr(jx_ckpt, "CHECKPOINT_VERSION",
                        CHECKPOINT_VERSION + 1)
    eng.save(path)
    jeng.save(jpath)
    monkeypatch.undo()
    with pytest.raises(CheckpointError, match="format version") as e:
        Engine.load(path, device="cpu")
    with pytest.raises(jx_ckpt.CheckpointError) as je:
        JxEngine.load(jpath)
    same_error(e, je, path, jpath)


@pytest.mark.parametrize("case", ["missing", "garbage", "alien"])
def test_checkpoint_rejects_garbage(tmp_path, case):
    """Each way a path is not a checkpoint raises CheckpointError with
    the reference's text."""
    path, jpath = tmp_path / "x.ckpt", tmp_path / "jx.ckpt"
    for p in (path, jpath):
        if case == "garbage":
            p.write_bytes(b"definitely not a checkpoint")
        elif case == "alien":
            with open(p, "wb") as f:
                np.savez(f, something=np.arange(3))
    match = {"missing": "no checkpoint", "garbage": "truncated or bit-",
             "alien": "not an Engine checkpoint"}[case]
    with pytest.raises(CheckpointError, match=match) as e:
        load_state(path, device="cpu")
    with pytest.raises(jx_ckpt.CheckpointError) as je:
        jx_ckpt.load_state(jpath)
    same_error(e, je, path, jpath)


def test_state_save_load_roundtrip_tuple_arrays(tmp_path, grid_data):
    """Tuple-valued array entries (HNSW's per-level adjacency) survive."""
    X, Q = grid_data
    state = hnsw.build(X[:300], metric="euclidean", M=8, ef_construction=32,
                       device="cpu")
    path = tmp_path / "hnsw.ckpt"
    save_state(state, path)
    restored, _ = load_state(path, device="cpu")
    assert restored.static == state.static
    assert len(restored["layers"]) == len(state["layers"]) > 1
    for a, b in zip(restored["layers"], state["layers"]):
        assert torch.equal(a, b)
    _, a = hnsw.search(state, Q[:8], k=5, ef=32)
    _, b = hnsw.search(restored, Q[:8], k=5, ef=32)
    assert torch.equal(a, b)


def test_engine_traced_knob_matches_static(ivf_pair, grid_data):
    """IVF's n_probes as a traced knob under a static max_probes cap
    (a 0-d tensor per call) matches the static path at every setting, and
    the reference's traced engine."""
    _, Q = grid_data
    jeng, eng = _engines(ivf_pair,
                         query_params={"max_probes": 30, "n_probes": 2},
                         traced_params=("n_probes",))
    for p in (1, 8, 30):
        got = eng.search(Q, n_probes=torch.tensor(p, dtype=torch.int32))
        want_d, want_i = ivf.search(eng.state, Q, k=K, n_probes=p)
        assert_same(got, (want_d.numpy(), want_i.numpy()))
        assert_same(got, jeng.search(Q, n_probes=jnp.int32(p)))


def test_engine_traced_knob_survives_checkpoint(ivf_pair, grid_data,
                                                tmp_path):
    """traced_params is engine configuration: a restored engine keeps
    serving traced knob values."""
    _, Q = grid_data
    _, eng = _engines(ivf_pair, query_params={"max_probes": 30,
                                              "n_probes": 2},
                      traced_params=("n_probes",))
    path = tmp_path / "traced.ckpt"
    eng.save(path)
    restored = Engine.load(path, device="cpu")
    assert restored.traced_params == ("n_probes",)
    eight = torch.tensor(8, dtype=torch.int32)
    assert_same(restored.search(Q, n_probes=eight),
                eng.search(Q, n_probes=eight))


def test_engine_per_request_overrides_keep_one_binding(ivf_pair, grid_data):
    """A pinned max_probes cap auto-demotes n_probes to a traced knob:
    per-request overrides through search() AND the submit()/flush() stream
    sweep the knob through the one bound search (the reference's one
    trace), answering as the static path and the reference do."""
    _, Q = grid_data
    jeng, eng = _engines(ivf_pair,
                         query_params={"max_probes": 30, "n_probes": 2})
    assert "n_probes" in eng.traced_params
    assert eng.traced_params == jeng.traced_params
    bound = eng._search
    for p in (1, 8, 30):
        got = eng.search(Q[:20], n_probes=p)
        _, want = ivf.search(eng.state, Q[:20], k=K, n_probes=p)
        np.testing.assert_array_equal(got[1], want.numpy())
        assert_same(got, jeng.search(Q[:20], n_probes=p))
    tickets = [(eng.submit(Q[0], n_probes=p), p) for p in (1, 8, 30, 8)]
    eng.flush()
    # 3 searches of 2 micro-batches each, then one per override group
    assert eng.stats["batches"] == 9
    for t, p in tickets:
        _, ids = t.result()
        _, want = ivf.search(eng.state, Q[:1], k=K, n_probes=p)
        np.testing.assert_array_equal(ids, want.numpy()[0])
    assert eng._search is bound


def test_engine_rejects_override_above_cap(ivf_pair, grid_data):
    """A traced knob above its static cap would be clamped by the
    in-window mask; the engine rejects it, with the reference's text."""
    _, Q = grid_data
    jeng, eng = _engines(ivf_pair,
                         query_params={"max_probes": 8, "n_probes": 2})
    with pytest.raises(ValueError, match="exceeds the engine's static") as e:
        eng.search(Q[:4], n_probes=9)
    with pytest.raises(ValueError) as je:
        jeng.search(Q[:4], n_probes=9)
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="exceeds the engine's static"):
        eng.search(Q[:4], n_probes=torch.tensor(9))
    # a bad override fails its own submit(); queued tickets are untouched
    good = eng.submit(Q[0], n_probes=4)
    with pytest.raises(ValueError, match="exceeds the engine's static"):
        eng.submit(Q[1], n_probes=9)
    eng.flush()
    _, ids_one = good.result()
    assert ids_one.shape == (K,)
    _, ids = eng.search(Q[:4], n_probes=8)   # at cap: fine
    assert ids.shape == (4, K)


def test_engine_checkpoint_roundtrips_static_caps(ivf_pair, grid_data,
                                                  tmp_path):
    """The static max_* cap is engine configuration: it survives a
    checkpoint round-trip, in either package's file."""
    _, Q = grid_data
    jeng, eng = _engines(ivf_pair,
                         query_params={"max_probes": 30, "n_probes": 2})
    path, jpath = tmp_path / "capped.ckpt", tmp_path / "jx_capped.ckpt"
    eng.save(path)
    jeng.save(jpath)
    for restored in (Engine.load(path, device="cpu"),
                     Engine.load(jpath, device="cpu")):
        assert restored.query_params["max_probes"] == 30
        assert restored.query_params["n_probes"] == 2
        assert "n_probes" in restored.traced_params
        assert_same(restored.search(Q[:8], n_probes=12),
                    eng.search(Q[:8], n_probes=12))
    assert_same(JxEngine.load(path).search(Q[:8], n_probes=12),
                eng.search(Q[:8], n_probes=12))


def test_engine_recall_gate(small_dataset):
    """The serve-smoke contract: a few hundred micro-batched queries
    through each package's engine reach recall >= 0.9, via the shared
    metrics path."""
    from repro.ann import distances as jx_D
    from repro.core.metrics import recall_from_arrays as jx_recall
    from repro_torch.ann import distances as D
    from repro_torch.core.metrics import recall_from_arrays

    ds = small_dataset
    kw = dict(metric="euclidean", build_params={"n_clusters": 30},
              query_params={"n_probes": 8}, k=K, batch_size=64)
    eng = Engine.build("IVF", ds.train, device="cpu", **kw)
    jeng = JxEngine.build("IVF", ds.train, **kw)
    rng = np.random.default_rng(0)
    sel = rng.integers(0, len(ds.test), 320)
    Q = ds.test[sel]
    _, ids = eng.search(Q)
    _, jids = jeng.search(Q)
    rec = float(np.mean(recall_from_arrays(
        D.pairwise_rows(Q, ds.train, ids, "euclidean", device="cpu"),
        ds.distances[sel], K, neighbors=ids)))
    jrec = float(np.mean(jx_recall(
        jx_D.pairwise_rows(Q, ds.train, jids, "euclidean"),
        ds.distances[sel], K, neighbors=jids)))
    assert rec >= 0.9 and jrec >= 0.9 and abs(rec - jrec) <= 0.01
    assert eng.stats["queries"] == 320 and eng.stats["batches"] == 5


def test_engine_refuses_sharded_states(ivf_pair, grid_data, tmp_path):
    """Sharded states are served (the name is kept from when the port
    refused them): an 8-shard ShardedIVF on the IVF state, built in the
    port and through a reference-written checkpoint, answers bit for bit
    as the direct sharded search, by the constructor and the checkpoint
    entry, at full coverage."""
    from repro.ann import sharded as jx_sh
    from repro_torch.ann import sharded as port_sh
    from repro_torch.dist import shard_state
    from repro_torch.dist.mesh import force_device_count

    jst, st = ivf_pair
    _, Q = grid_data
    prev = force_device_count(8)
    try:
        st8 = shard_state.shard_index(st, n_shards=8)
        want = port_sh.ivf_search(st8, Q, k=K, n_probes=8)
        for eng in (Engine(st8, k=K, query_params={"n_probes": 8}),
                    Engine.from_checkpoint_entry(
                        st8, {"k": K, "query_params": {"n_probes": 8}})):
            assert_same(eng.search(Q), (want[0].numpy(), want[1].numpy()))
            assert eng.last_coverage == 1.0 and eng.stats["degraded"] == 0
        path = tmp_path / "sh1.ckpt"
        jx_ckpt.save(path, jx_sh.SS.shard_index(jst, n_shards=1))
        eng = Engine.load(path, device="cpu", k=K,
                          query_params={"n_probes": 8})
        assert eng.state.algo == "ShardedIVF"
        want = port_sh.ivf_search(eng.state, Q, k=K, n_probes=8)
        assert_same(eng.search(Q), (want[0].numpy(), want[1].numpy()))
        assert_same(eng.search(Q), JxEngine.load(
            path, k=K, query_params={"n_probes": 8}).search(Q))
    finally:
        force_device_count(prev)


def test_autotune_adopts_the_chosen_point(ivf_pair, grid_data):
    """autotune runs the tuner on the engine's own state and adopts the
    best point as a traced knob under a raised cap; an infeasible floor
    leaves the engine as it was."""
    from repro_torch.data import exact_knn
    from repro_torch.tune import Constraint

    X, Q = grid_data
    _, eng = _engines(ivf_pair, query_params={"n_probes": 1})
    gt = exact_knn(X, Q, K, "euclidean", device="cpu")[1]
    before = (dict(eng.query_params), eng.traced_params, eng._search)
    res = eng.autotune(Q, gt, knob_grid={"n_probes": (1, 30)},
                       constraint=Constraint.min_recall(1.01),
                       repetitions=1)
    assert res.best is None
    assert (eng.query_params, eng.traced_params, eng._search) == before
    res = eng.autotune(Q, gt, knob_grid={"n_probes": (1, 30)},
                       constraint=Constraint.min_recall(0.99),
                       repetitions=1)
    assert res.best is not None and res.best.recall >= 0.99
    assert eng.query_params["max_probes"] == 30
    assert eng.query_params["n_probes"] == res.best_params()["n_probes"]
    assert "n_probes" in eng.traced_params
    want = ivf.search(eng.state, Q, k=K, n_probes=eng.query_params[
        "n_probes"])
    assert_same(eng.search(Q), (want[0].numpy(), want[1].numpy()))


# --------------------------------------------------------------------------
# checkpoint interchange, both directions
# --------------------------------------------------------------------------

def _mutated(pkg, state, new, dead):
    """``state`` after one insert of ``new`` and one delete of ``dead``,
    by ``pkg``'s mutate module."""
    state, _ = pkg.insert(state, new)
    return pkg.delete(state, dead)


def _case(name, rng):
    """(metric, X, Q, reference state, port state, engine kwargs) for one
    interchange case; each package builds its own state of the same rows
    (integer grids) with the same parameters."""
    X, Q = _grid(rng, 300, 12), _grid(rng, 12, 12)
    if name == "BruteForce":
        return (X, Q, jx_bf.build(X, metric="euclidean"),
                bruteforce.build(X, metric="euclidean", device="cpu"), {})
    if name == "IVF(max_probes)":
        kw = {"query_params": {"n_probes": 3, "max_probes": 8}}
        return (X, Q, jx_ivf.build(X, metric="euclidean", n_clusters=8),
                ivf.build(X, metric="euclidean", n_clusters=8,
                          device="cpu"), kw)
    if name == "HNSW":
        kw = {"query_params": {"ef": 32}}
        return (X, Q, jx_hnsw.build(X, metric="euclidean", M=8,
                                    ef_construction=32),
                hnsw.build(X, metric="euclidean", M=8, ef_construction=32,
                           device="cpu"), kw)
    if name == "BruteForce(PQ)":
        pq = {"pq": {"m": 4, "bits": 4}}
        kw = {"query_params": {"n_cand": 150}}
        return (X, Q, jx_bf.build(X, metric="euclidean", quantize=pq),
                bruteforce.build(X, metric="euclidean", quantize=pq,
                                 device="cpu"), kw)
    if name == "E2LSH":
        kw = {"query_params": {"n_probes": 4}}
        return (X, Q, jx_lsh.e2lsh_build(X, n_tables=4),
                lsh.e2lsh_build(X, n_tables=4, device="cpu"), kw)
    if name == "MutableIVF":
        new = _grid(rng, 6, 12)
        kw = {"query_params": {"n_probes": 8}}
        return (X, Q, _mutated(jx_mutate, jx_mutate.IVF_SPEC.build(
                    X, metric="euclidean", n_clusters=8, delta_capacity=16),
                    new, [0, 5, 302]),
                _mutated(mutate, mutate.IVF_SPEC.build(
                    X, metric="euclidean", n_clusters=8, delta_capacity=16,
                    device="cpu"), new, [0, 5, 302]), kw)
    assert name == "MutableBruteForce(angular)"
    new = _grid(rng, 6, 12)
    return (X, Q, _mutated(jx_mutate, jx_mutate.BRUTEFORCE_SPEC.build(
                X, metric="angular", delta_capacity=16), new, [0, 5, 302]),
            _mutated(mutate, mutate.BRUTEFORCE_SPEC.build(
                X, metric="angular", delta_capacity=16, device="cpu"),
                new, [0, 5, 302]), {})


CASES = ["BruteForce", "IVF(max_probes)", "HNSW", "BruteForce(PQ)", "E2LSH",
         "MutableIVF", "MutableBruteForce(angular)"]


@pytest.mark.parametrize("name", CASES)
def test_reference_checkpoint_serves_in_the_port(name, tmp_path):
    """A reference-written file loads in the port, its engine answers as
    the reference's, and the port writes it back unchanged: every member's
    dtype, shape and bytes, and the metadata record."""
    X, Q, jst, _, kw = _case(name, np.random.default_rng(31))
    jeng = JxEngine(jst, k=K, batch_size=8, **kw)
    jpath, path = tmp_path / "jx.ckpt", tmp_path / "port.ckpt"
    jeng.save(jpath)
    eng = Engine.load(jpath, device="cpu")
    assert eng.query_params == jeng.query_params
    assert eng.traced_params == jeng.traced_params
    atol = ANGULAR_ATOL if "angular" in name else 0.0
    assert_same(eng.search(Q), jeng.search(Q), atol)
    eng.save(path)
    assert npz_members(path) == npz_members(jpath)
    if name.startswith("Mutable"):
        assert eng.state["count"].device.type == "cpu"
        if "BruteForce" in name:
            assert eng.state["main"].static["exact_angular"] is True


@pytest.mark.parametrize("name", CASES)
def test_port_checkpoint_serves_in_the_reference(name, tmp_path):
    """A port-written file loads in the reference, and the reference's
    engine answers as the port's on the port's own build."""
    X, Q, _, st, kw = _case(name, np.random.default_rng(31))
    eng = Engine(st, k=K, batch_size=8, **kw)
    path = tmp_path / "port.ckpt"
    eng.save(path)
    jeng = JxEngine.load(path)
    assert jeng.query_params == eng.query_params
    atol = ANGULAR_ATOL if "angular" in name else 0.0
    assert_same(eng.search(Q), jeng.search(Q), atol)


def test_hamming_codes_are_written_as_uint32(tmp_path):
    """Packed codes live in int32 tensors in the port and are written as
    the reference's uint32, both ways, for a frozen and a mutable state."""
    from repro.ann import hamming as jx_hamming
    from repro_torch.ann import hamming

    rng = np.random.default_rng(41)
    codes = rng.integers(0, 2**32, (200, 4), dtype=np.uint64).astype(
        np.uint32)
    Q = codes[:6] ^ np.uint32(1 << 7)
    for jst, st in (
            (jx_hamming.bruteforce_build(codes),
             hamming.bruteforce_build(codes, device="cpu")),
            (_mutated(jx_mutate, jx_mutate.BRUTEFORCE_SPEC.build(
                codes, metric="hamming", delta_capacity=8),
                codes[:3] ^ np.uint32(1), [1, 201]),
             _mutated(mutate, mutate.BRUTEFORCE_SPEC.build(
                 codes, metric="hamming", delta_capacity=8, device="cpu"),
                 codes[:3] ^ np.uint32(1), [1, 201]))):
        path, jpath = tmp_path / "p.ckpt", tmp_path / "j.ckpt"
        Engine(st, k=5, batch_size=8).save(path)
        jeng = JxEngine(jst, k=5, batch_size=8)
        jeng.save(jpath)
        arrays, _ = npz_members(path)
        jarrays, _ = npz_members(jpath)
        for key, (dtype, shape, _) in jarrays.items():
            assert arrays[key][:2] == (dtype, shape)
        assert any(dt == np.dtype(np.uint32).str for dt, _, _ in
                   arrays.values())
        loaded = Engine.load(jpath, device="cpu")
        assert_same(loaded.search(Q), jeng.search(Q))
        assert_same(JxEngine.load(path).search(Q),
                    Engine(st, k=5, batch_size=8).search(Q))


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_two_tenant_archive_interchanges(direction, tmp_path):
    """A two-tenant archive written by one package loads in the other,
    each tenant with its extras, and serves the same answers."""
    rng = np.random.default_rng(51)
    X, Q = _grid(rng, 300, 12), _grid(rng, 10, 12)
    extra = {"k": 5, "batch_size": 8, "query_params": {"n_probes": 4},
             "traced_params": []}
    jstates = {"ivf": jx_ivf.build(X, metric="euclidean", n_clusters=8),
               "bf": jx_bf.build(X, metric="euclidean")}
    states = {"ivf": ivf.build(X, metric="euclidean", n_clusters=8,
                               device="cpu"),
              "bf": bruteforce.build(X, metric="euclidean", device="cpu")}
    path = tmp_path / "multi.ckpt"
    if direction == "reference_to_port":
        jx_ckpt.save(path, {"ivf": (jstates["ivf"], extra),
                            "bf": jstates["bf"]})
        loaded = checkpoint.load(path, device="cpu")
        serving = {t: (Engine.from_checkpoint_entry(*loaded[t]),
                       JxEngine.from_checkpoint_entry(jstates[t],
                                                      loaded[t][1]))
                   for t in ("ivf", "bf")}
    else:
        checkpoint.save(path, {"ivf": (states["ivf"], extra),
                               "bf": states["bf"]})
        loaded = jx_ckpt.load(path)
        serving = {t: (Engine.from_checkpoint_entry(states[t],
                                                    loaded[t][1]),
                       JxEngine.from_checkpoint_entry(*loaded[t]))
                   for t in ("ivf", "bf")}
    assert sorted(loaded) == ["bf", "ivf"]
    assert loaded["ivf"][1] == extra and loaded["bf"][1] == {}
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
    assert manifest == {"archive_version": 1, "checkpoint_version": 4,
                        "tenants": {"bf": "states/0.npz",
                                    "ivf": "states/1.npz"}}
    for tenant, (eng, jeng) in serving.items():
        assert eng.k == jeng.k
        assert_same(eng.search(Q), jeng.search(Q))
    with pytest.raises(CheckpointError, match="holds 2 tenant states"):
        checkpoint.load(path, device="cpu").only
