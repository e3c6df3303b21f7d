"""The port's async serving tier (``repro_torch.serve.async_engine``,
``metrics``, ``retry``) against the JAX package's: the pump cases of
``tests/test_serving.py`` and the retry, pump-supervisor and compaction
cases of ``tests/test_faults.py`` that need no sharded state.

Both pumps serve the same state (the reference's IVF, carried into the
port through a reference-written checkpoint) and get the same requests;
rows are small-integer grids, so every euclidean distance is exact: ids
bitwise and distances equal.  Histograms, snapshots, backoff delays and
error texts must equal the reference's.

No test sleeps or waits on the clock (``result(timeout=30)`` only guards
against a hang): a deadline is already expired (``deadline_ms=-1``), a
pump that must not flush gets a flush timeout it never reaches
(``max_wait_ms=1e7``; ``close()`` drains at once), and a pump or a
rebuild that must be held waits on a ``threading.Event`` inside a test
double.  The reference's retry cases raise a ``ShardFault`` from a
sharded state; here a test double's ``_run_padded`` raises
``TransientFault`` on the attempts each case schedules, in both packages.
"""

import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ann import bruteforce as jx_bf  # noqa: E402
from repro.ann import ivf as jx_ivf  # noqa: E402
from repro.serve import AsyncEngine as JxAsync  # noqa: E402
from repro.serve import Engine as JxEngine  # noqa: E402
from repro.serve import checkpoint as jx_ckpt  # noqa: E402
from repro.serve import errors as jx_errors  # noqa: E402
from repro.serve import faults as jx_faults  # noqa: E402
from repro.serve import metrics as jx_metrics  # noqa: E402
from repro.serve import retry as jx_retry  # noqa: E402
from repro_torch.ann import bruteforce, ivf  # noqa: E402
from repro_torch.serve import errors as port_errors  # noqa: E402
from repro_torch.mutate import delta  # noqa: E402
from repro_torch.serve import retry  # noqa: E402
from repro_torch.serve import (DEFAULT_TENANT, AdmissionError,  # noqa: E402
                               AsyncEngine, CheckpointError, CompactionError,
                               DeadlineExceeded, Engine, EngineClosed,
                               EngineDegraded, FaultPlan, LatencyHistogram,
                               PumpFault, RetriesExhausted, RetryPolicy,
                               ServeError, ServeMetrics, ShardFault,
                               TransientFault, checkpoint, faults)

K = 10
HUNG = 30           # seconds: a guard against a hang, never a wait


def _grid(rng, m, d):
    return rng.integers(-8, 8, size=(m, d)).astype(np.float32)


def assert_same(got, want):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    for pkg in (faults, jx_faults):
        pkg.clear()
    yield
    faults.clear()
    jx_faults.clear()


@pytest.fixture(scope="module")
def grid_data():
    rng = np.random.default_rng(31)
    return _grid(rng, 600, 12), _grid(rng, 40, 12)


@pytest.fixture(scope="module")
def ivf_pair(grid_data, tmp_path_factory):
    """(reference IVF state, the port's copy through a reference-written
    file): 30 lists."""
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
    kw.setdefault("query_params", {"n_probes": 8, "max_probes": 30})
    return JxEngine(jst, **kw), Engine(st, **kw)


# --------------------------------------------------------------------------
# the pump: parity, deadlines, admission, shutdown
# --------------------------------------------------------------------------

def test_async_parity_with_sync_search(ivf_pair, grid_data):
    _, Q = grid_data
    jeng, eng = _engines(ivf_pair)
    with AsyncEngine(eng, max_wait_ms=5.0) as srv:
        got = srv.search(Q[:20])
    with JxAsync(jeng, max_wait_ms=5.0) as jsrv:
        want = jsrv.search(Q[:20])
    assert_same(got, want)
    assert_same(got, eng.search(Q[:20]))
    snap, jsnap = srv.metrics.snapshot(), jsrv.metrics.snapshot()
    assert snap["counters"]["served"] == jsnap["counters"]["served"] == 20
    assert snap["counters"]["batches"] >= 2        # 20 queries, batch 16
    assert snap["latency_ms"]["p95"] > 0
    assert snap.keys() == jsnap.keys()
    assert snap["latency_ms"].keys() == jsnap["latency_ms"].keys()
    assert snap["coverage"]["min"] == jsnap["coverage"]["min"] == 1.0
    assert snap["tenants"].keys() == jsnap["tenants"].keys() \
        == {DEFAULT_TENANT}


def test_async_deadline_expiry_does_not_poison_batch(ivf_pair, grid_data):
    _, Q = grid_data
    for pkg_async, eng in zip((JxAsync, AsyncEngine), _engines(ivf_pair)):
        with pkg_async(eng, max_wait_ms=1e7) as srv:
            doomed = srv.submit(Q[0], deadline_ms=-1.0)
            healthy = srv.submit(Q[1])
        with pytest.raises(TimeoutError, match="missed its -1.0 ms"):
            doomed.result(timeout=HUNG)
        assert type(doomed._error).__name__ == "DeadlineExceeded"
        _, ids = healthy.result(timeout=HUNG)
        np.testing.assert_array_equal(ids, eng.search(Q[1:2])[1][0])
        assert srv.metrics.counter("timed_out") == 1
        assert srv.metrics.counter("served") == 1
    assert isinstance(doomed._error, DeadlineExceeded)


def test_async_admission_control_rejects_typed(ivf_pair, grid_data):
    """max_queue below the flush threshold and a flush timeout the pump
    never reaches: the queue fills, the fifth request is refused typed,
    and close() answers the four admitted ones."""
    _, Q = grid_data
    jeng, eng = _engines(ivf_pair)
    texts = []
    for pkg_async, e, err in ((JxAsync, jeng, jx_errors.AdmissionError),
                              (AsyncEngine, eng, AdmissionError)):
        srv = pkg_async(e, max_wait_ms=1e7, max_queue=4)
        try:
            tickets = [srv.submit(q) for q in Q[:4]]
            with pytest.raises(err, match="rejected, not") as exc:
                srv.submit(Q[4])
            texts.append(str(exc.value))
            assert srv.metrics.counter("rejected") == 1
            assert srv.qsize() == 4
        finally:
            srv.close()
        assert all(t.done() for t in tickets)
        _, want = e.search(Q[:4])
        for i, t in enumerate(tickets):
            np.testing.assert_array_equal(t.result()[1], want[i])
    assert texts[0] == texts[1]


def test_async_close_drains_and_then_refuses(ivf_pair, grid_data):
    _, Q = grid_data
    _, eng = _engines(ivf_pair)
    srv = AsyncEngine(eng, max_wait_ms=1e7)
    pending = [srv.submit(q) for q in Q[:3]]
    srv.close()
    assert all(t.done() for t in pending)          # drained, not dropped
    with pytest.raises(EngineClosed, match="submit\\(\\) after close"):
        srv.submit(Q[0])
    srv.close()                                    # idempotent
    assert not srv._pump.is_alive() and srv.closed


def test_async_multi_tenant_routing_and_parity(ivf_pair, grid_data):
    _, Q = grid_data
    jst, st = ivf_pair
    tiers = {"std": 4, "gold": 30}

    def tenants(cls, state):
        return {t: cls(state, k=K, batch_size=16,
                       query_params={"n_probes": p, "max_probes": 30})
                for t, p in tiers.items()}

    out = {}
    for name, pkg_async, engines in (
            ("port", AsyncEngine, tenants(Engine, st)),
            ("ref", JxAsync, tenants(JxEngine, jst))):
        with pkg_async(engines, max_wait_ms=5.0) as srv:
            assert srv.tenants == ("gold", "std")
            with pytest.raises(ValueError, match="pass tenant="):
                srv.submit(Q[0])
            with pytest.raises(ValueError, match="unknown tenant"):
                srv.submit(Q[0], tenant="bronze")
            out[name] = {t: srv.search(Q[:8], tenant=t) for t in tiers}
        snap = srv.metrics.snapshot()
        assert snap["tenants"]["std"]["counters"]["served"] == 8
        assert snap["tenants"]["gold"]["counters"]["served"] == 8
    for t, p in tiers.items():
        assert_same(out["port"][t], out["ref"][t])
        want = ivf.search(st, Q[:8], k=K, n_probes=p)
        assert_same(out["port"][t], (want[0].numpy(), want[1].numpy()))


def test_async_mixed_overrides_keep_one_padded_shape(ivf_pair, grid_data):
    """Per-request overrides ride their own micro-batches, each at the
    engine's padded shape, and answer as the static search at that value
    (the reference's zero-retraces case)."""
    _, Q = grid_data
    jeng, eng = _engines(ivf_pair)
    probes = [1, 8, 30, 8, 1, 30, 8, 8]
    got = []
    for pkg_async, e in ((AsyncEngine, eng), (JxAsync, jeng)):
        with pkg_async(e, max_wait_ms=2.0) as srv:
            tickets = [srv.submit(Q[i], n_probes=p)
                       for i, p in enumerate(probes)]
            got.append([t.result(timeout=HUNG) for t in tickets])
    for i, p in enumerate(probes):
        assert_same(got[0][i], got[1][i])
        _, want = ivf.search(eng.state, Q[i:i + 1], k=K, n_probes=p)
        np.testing.assert_array_equal(got[0][i][1], want[0].numpy())
    s = eng.stats
    assert s["batches"] * eng.batch_size == s["queries"] + s["padded"]
    assert s["queries"] == len(probes) and s["batches"] >= 3


def _mutable_pair(rng, n=400, d=12, capacity=64):
    X = _grid(rng, n, d)
    new = _grid(rng, 32, d)
    pair = []
    for cls in (JxEngine, Engine):
        kw = {} if cls is JxEngine else {"device": "cpu"}
        e = cls.build("MutableBruteForce", X, metric="euclidean",
                      build_params={"delta_capacity": capacity},
                      k=K, batch_size=16, **kw)
        e.insert(new, auto_compact=False)
        e.delete(np.arange(0, 40, 7))
        pair.append(e)
    return X, pair


def test_async_compaction_swap_under_fire():
    """A client thread submits while compact() hot-swaps the state five
    times: every admitted ticket resolves with the answer the reference's
    engine gives for that query (old or new state: the same live rows),
    never an error, never dropped."""
    rng = np.random.default_rng(21)
    X, (jeng, eng) = _mutable_pair(rng)
    Q = _grid(rng, 200, X.shape[1])
    results, started = [], threading.Event()

    def client():
        for i, q in enumerate(Q):
            while True:
                try:
                    results.append((i, srv.submit(q)))
                    break
                except AdmissionError:
                    pass                   # shed: submit again
            if i == 16:
                started.set()

    with AsyncEngine(eng, max_wait_ms=1.0, max_queue=64) as srv:
        thread = threading.Thread(target=client, daemon=True)
        thread.start()
        assert started.wait(HUNG)
        for _ in range(5):                 # five swaps under fire
            srv.compact()
        thread.join(HUNG)
    assert not thread.is_alive() and len(results) == len(Q)
    want_d, want_i = jeng.search(Q)
    for i, t in results:
        assert t.done(), "ticket dropped across a swap"
        assert t._error is None
        assert_same(t.result(timeout=0), (want_d[i], want_i[i]))
    assert eng.stats["compactions"] == 5
    assert int(eng.state["count"]) == 0            # delta folded in
    assert srv.metrics.counter("compactions") == 5


def test_async_submit_rejects_override_above_cap(ivf_pair, grid_data):
    _, Q = grid_data
    texts = []
    for pkg_async, e in zip((JxAsync, AsyncEngine), _engines(ivf_pair)):
        with pkg_async(e, max_wait_ms=5.0) as srv:
            with pytest.raises(ValueError,
                               match="exceeds the engine's static") as exc:
                srv.submit(Q[0], n_probes=31)
            texts.append(str(exc.value))
            assert srv.metrics.counter("submitted") == 0
    assert texts[0] == texts[1]


def test_async_device_failure_fails_tickets_not_pump(ivf_pair, grid_data):
    """A poisoned batch (a query of the wrong width) fails ITS tickets,
    counted as failed; the pump survives and serves the next request."""
    _, Q = grid_data
    _, eng = _engines(ivf_pair)
    with AsyncEngine(eng, max_wait_ms=2.0) as srv:
        bad = srv.submit(np.zeros(3, np.float32))
        with pytest.raises(Exception) as exc:
            bad.result(timeout=HUNG)
        assert not isinstance(exc.value, TimeoutError)  # failed, not hung
        assert srv.metrics.counter("failed") == 1
        _, ids = srv.submit(Q[0]).result(timeout=HUNG)
    np.testing.assert_array_equal(ids, eng.search(Q[:1])[1][0])


# --------------------------------------------------------------------------
# checkpoints through the pump
# --------------------------------------------------------------------------

def test_archive_roundtrip_multi_tenant(ivf_pair, grid_data, tmp_path):
    """The port's pump archives both tenants; the port and the reference
    each restore it and answer alike."""
    _, Q = grid_data
    _, st = ivf_pair
    engines = {"std": Engine(st, k=K, batch_size=16,
                             query_params={"n_probes": 4}),
               "gold": Engine(st, k=K, batch_size=16,
                              query_params={"n_probes": 16})}
    path = tmp_path / "tenants.ckpt"
    src = AsyncEngine(engines, max_wait_ms=5.0)
    src.save(path)
    src.close()
    restored = AsyncEngine.load(path, device="cpu", max_wait_ms=5.0)
    jrestored = JxAsync.load(path, max_wait_ms=5.0)
    try:
        assert restored.tenants == jrestored.tenants == ("gold", "std")
        assert restored.engines["std"].query_params["n_probes"] == 4
        assert restored.engines["gold"].query_params["n_probes"] == 16
        got = restored.search(Q[:8], tenant="gold")
        want = jrestored.search(Q[:8], tenant="gold")
    finally:
        restored.close()
        jrestored.close()
    assert_same(got, want)
    assert_same(got, engines["gold"].search(Q[:8]))
    with pytest.raises(CheckpointError, match="2 tenant states"):
        checkpoint.load_state(path, device="cpu")


def test_async_load_accepts_single_state_checkpoint(ivf_pair, grid_data,
                                                    tmp_path):
    _, Q = grid_data
    jeng, eng = _engines(ivf_pair)
    path = tmp_path / "single.ckpt"
    jeng.save(path)
    srv = AsyncEngine.load(path, device="cpu", max_wait_ms=5.0)
    try:
        assert srv.tenants == (DEFAULT_TENANT,) == ("default",)
        got = srv.search(Q[:4])                    # tenant= implied
    finally:
        srv.close()
    assert_same(got, jeng.search(Q[:4]))


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

def test_latency_histogram_percentiles_equal_reference():
    rng = np.random.default_rng(0)
    samples = rng.uniform(0.001, 0.1, 5000)
    h, jh = LatencyHistogram(), jx_metrics.LatencyHistogram()
    for s in samples:
        h.record(s)
        jh.record(s)
    assert h._counts == jh._counts
    for p in (0, 1, 5, 50, 95, 99, 99.9, 100):
        assert h.percentile(p) == jh.percentile(p)
    for p in (50, 95, 99):
        want = float(np.percentile(samples, p))
        assert abs(h.percentile(p) - want) / want < 0.06
    assert h.percentile(100) <= h.hi_s
    assert h.snapshot_ms() == jh.snapshot_ms()
    # the same bucket edges at other ranges, and the empty histogram
    for lo, hi, bins in ((1e-3, 1.0, 48), (1e-6, 120.0, 10)):
        a, b = LatencyHistogram(lo, hi, bins), \
            jx_metrics.LatencyHistogram(lo, hi, bins)
        assert len(a._counts) == len(b._counts)
        assert np.isnan(a.percentile(50)) and np.isnan(b.percentile(50))
        for s in (0.0, lo, lo * 1.0001, hi, 10 * hi, 0.37 * hi):
            assert a._bucket(s) == b._bucket(s)


def test_serve_metrics_snapshots_equal_reference():
    m, jm = ServeMetrics(), jx_metrics.ServeMetrics()
    for pkg in (m, jm):
        pkg.count("served", tenant="a")
        pkg.count("served", 2, tenant="b")
        pkg.count("batches")
        pkg.observe(0.010, tenant="a")
        pkg.observe(0.100, tenant="b")
        pkg.observe_coverage(1.0, tenant="a")
        pkg.observe_coverage(0.5)
    snap = m.snapshot()
    assert snap == jm.snapshot()
    assert snap["counters"]["served"] == 3
    assert snap["tenants"]["a"]["counters"]["served"] == 1
    assert snap["tenants"]["b"]["counters"]["served"] == 2
    assert snap["tenants"]["a"]["latency_ms"]["p50"] < \
        snap["tenants"]["b"]["latency_ms"]["p50"]
    assert "coverage" not in snap["tenants"]["b"]
    assert m.counter("served", tenant="b") == 2
    assert m.percentile(50, tenant="a") == jm.percentile(50, tenant="a")
    assert m.coverage_percentile(5) == jm.coverage_percentile(5)
    # the pump's batched path records what per-request calls record
    batched = ServeMetrics()
    batched.count("served", 1, tenant="a")
    batched.count("served", 2, tenant="b")
    batched.count("batches")
    batched.observe_many([0.010], tenant="a")
    batched.observe_many([0.100], tenant="b")
    batched.observe_coverage(1.0, tenant="a", n=1)
    batched.observe_coverage(0.5)
    assert batched.snapshot() == snap
    lat = [0.001 * i for i in range(1, 300)]
    one, many = ServeMetrics(), ServeMetrics()
    for x in lat:
        one.observe(x, tenant="t")
        one.observe_coverage(1.0, tenant="t")
    many.observe_many(lat, tenant="t")
    many.observe_coverage(1.0, tenant="t", n=len(lat))
    assert many.snapshot() == one.snapshot()
    with pytest.raises(ValueError) as exc:
        m.count("serverd")
    with pytest.raises(ValueError) as jexc:
        jm.count("serverd")
    assert str(exc.value) == str(jexc.value)


def test_serve_metrics_counts_under_threads():
    """The counters stay exact with several threads counting at once."""
    m = ServeMetrics()

    def work(t):
        for _ in range(2000):
            m.count("served", tenant=t)
            m.observe(0.001, tenant=t)

    threads = [threading.Thread(target=work, args=(f"t{i % 2}",))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(HUNG)
    snap = m.snapshot()
    assert snap["counters"]["served"] == 8000
    assert snap["latency_ms"]["count"] == 8000
    assert snap["tenants"]["t0"]["counters"]["served"] == 4000


def test_no_deprecation_warnings_on_new_api(ivf_pair, grid_data):
    _, Q = grid_data
    _, eng = _engines(ivf_pair)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        t = eng.submit(Q[0])
        eng.flush()
        t.result()
        with AsyncEngine(eng, max_wait_ms=2.0) as srv:
            srv.search(Q[:4])


# --------------------------------------------------------------------------
# retries (tests/test_faults.py), through a test double
# --------------------------------------------------------------------------

def test_retry_policy_backoff_and_spec_equal_reference():
    pol = RetryPolicy(max_attempts=4, base_ms=2.0, multiplier=2.0,
                      max_ms=5.0, jitter=0.5, seed=3)
    jpol = jx_retry.RetryPolicy(max_attempts=4, base_ms=2.0, multiplier=2.0,
                                max_ms=5.0, jitter=0.5, seed=3)
    for attempt in range(1, 6):
        for token in (0, 1, 9, 10, 12345):
            assert pol.backoff_s(attempt, token) == \
                jpol.backoff_s(attempt, token)
    assert pol.backoff_s(1, token=9) != pol.backoff_s(1, token=10)
    nojit = RetryPolicy(base_ms=2.0, multiplier=2.0, max_ms=5.0, jitter=0.0)
    assert [nojit.backoff_s(a) for a in (1, 2, 3)] == [0.002, 0.004, 0.005]
    assert 0.002 <= pol.backoff_s(2, token=1) <= 0.006
    assert pol.retryable(ShardFault("x")) and pol.retryable(
        TransientFault("x"))
    assert not pol.retryable(ValueError()) \
        and not pol.retryable(jx_errors.ShardFault("x"))
    spec = "attempts=4,base_ms=2,multiplier=3,max_ms=9,jitter=0.25,seed=5"
    assert RetryPolicy.from_spec(spec).__dict__ == \
        jx_retry.RetryPolicy.from_spec(spec).__dict__
    for bad in (lambda m: m.RetryPolicy.from_spec("atempts=4"),
                lambda m: m.RetryPolicy.from_spec("attempts"),
                lambda m: m.RetryPolicy(max_attempts=0),
                lambda m: m.RetryPolicy(base_ms=-1.0),
                lambda m: m.RetryPolicy(jitter=1.5)):
        with pytest.raises(ValueError) as got:
            bad(retry)
        with pytest.raises(ValueError) as want:
            bad(jx_retry)
        assert str(got.value) == str(want.value)


def _flaky(cls, fault, fail_on, hold=None):
    """An engine class whose ``_run_padded`` raises ``fault`` on the
    1-based call numbers in ``fail_on`` (every call for ``"all"``), and
    first waits on ``hold`` where one is given."""

    class Flaky(cls):
        calls = 0

        def _run_padded(self, Qb, n_live, overrides):
            if hold is not None:
                assert hold.wait(HUNG)
            type(self).calls += 1
            if fail_on == "all" or type(self).calls in fail_on:
                raise fault(f"injected: attempt {type(self).calls} failed")
            return super()._run_padded(Qb, n_live, overrides)

    return Flaky


def _flaky_pair(rng, fail_on, hold=None):
    X = _grid(rng, 300, 16)
    jeng = _flaky(JxEngine, jx_errors.TransientFault, fail_on, hold)(
        jx_bf.build(X, metric="euclidean"), k=5, batch_size=8)
    eng = _flaky(Engine, TransientFault, fail_on, hold)(
        bruteforce.build(X, metric="euclidean", device="cpu"), k=5,
        batch_size=8)
    return X, jeng, eng


def _both(fn, rng_seed, fail_on, hold=None):
    """Run ``fn(pkg_async, engine, errors, X)`` for each package."""
    X, jeng, eng = _flaky_pair(np.random.default_rng(rng_seed), fail_on,
                               hold)
    return [fn(JxAsync, jeng, jx_errors, X, jx_retry.RetryPolicy),
            fn(AsyncEngine, eng, port_errors, X, RetryPolicy)]


def test_transient_fault_retries_then_succeeds():
    def case(pkg_async, eng, errors, X, policy):
        pol = policy(max_attempts=3, base_ms=0.1, jitter=0.0)
        with pkg_async(eng, max_wait_ms=1.0, retry=pol) as srv:
            d, ids = srv.submit(X[0]).result(timeout=HUNG)
            return ((d, ids), type(eng).calls,
                    {c: srv.metrics.counter(c)
                     for c in ("retried", "served", "failed")})

    (got, calls, counts), (want, jcalls, jcounts) = \
        _both(case, 3, fail_on=(1,))[::-1]
    assert_same(got, want)
    assert calls == jcalls == 2
    assert counts == jcounts == {"retried": 1, "served": 1, "failed": 0}


def test_retries_exhausted_is_typed_and_counted():
    def case(pkg_async, eng, errors, X, policy):
        pol = policy(max_attempts=2, base_ms=0.1, jitter=0.0)
        with pkg_async(eng, max_wait_ms=1.0, retry=pol) as srv:
            with pytest.raises(errors.RetriesExhausted) as exc:
                srv.submit(X[0]).result(timeout=HUNG)
            assert isinstance(exc.value.__cause__, errors.TransientFault)
            counts = {c: srv.metrics.counter(c)
                      for c in ("failed", "retried", "served")}
            return str(exc.value), str(exc.value.__cause__), counts

    got, want = _both(case, 4, fail_on="all")[::-1]
    assert got == want
    assert got[2] == {"failed": 1, "retried": 1, "served": 0}
    assert got[0].startswith("all 2 attempts failed; last: TransientFault")


def test_pump_survives_exhausted_retries():
    """After an exhausted batch, a later request is served."""
    def case(pkg_async, eng, errors, X, policy):
        pol = policy(max_attempts=2, base_ms=0.1, jitter=0.0)
        with pkg_async(eng, max_wait_ms=1.0, retry=pol) as srv:
            with pytest.raises(errors.RetriesExhausted):
                srv.submit(X[0]).result(timeout=HUNG)
            return srv.submit(X[1]).result(timeout=HUNG)

    got, want = _both(case, 4, fail_on=(1, 2))[::-1]
    assert_same(got, want)
    assert (got[1] >= 0).all()


def test_deadline_aware_retry_budget_gives_up_early():
    """A backoff past every live deadline: the first failure surfaces as
    RetriesExhausted at once, with no retry taken (and no sleep)."""
    def case(pkg_async, eng, errors, X, policy):
        pol = policy(max_attempts=5, base_ms=10_000.0, max_ms=10_000.0,
                     jitter=0.0)
        with pkg_async(eng, max_wait_ms=1.0, retry=pol) as srv:
            t = srv.submit(X[0], deadline_ms=200.0)
            with pytest.raises(errors.RetriesExhausted,
                               match="no live deadline") as exc:
                t.result(timeout=HUNG)
            return (str(exc.value), type(eng).calls,
                    srv.metrics.counter("retried"),
                    srv.metrics.counter("failed"))

    got, want = _both(case, 5, fail_on=(1,))[::-1]
    assert got == want
    assert got[1:] == (1, 0, 1)


def test_a_non_transient_fault_is_not_retried():
    """Any other error fails the batch's tickets as raised, with no
    retry: a device fault is never swallowed."""
    class Broken(Engine):
        def _run_padded(self, Qb, n_live, overrides):
            raise RuntimeError("CUDA error: an illegal memory access")

    rng = np.random.default_rng(6)
    X = _grid(rng, 100, 8)
    eng = Broken(bruteforce.build(X, device="cpu"), k=5, batch_size=8)
    with AsyncEngine(eng, max_wait_ms=1.0) as srv:
        tickets = [srv.submit(x) for x in X[:3]]
        for t in tickets:
            with pytest.raises(RuntimeError, match="illegal memory"):
                t.result(timeout=HUNG)
        assert srv.metrics.counter("failed") == 3
        assert srv.metrics.counter("retried") == 0
        assert srv._pump.is_alive()


# --------------------------------------------------------------------------
# the pump supervisor (tests/test_faults.py), on an unsharded engine
# --------------------------------------------------------------------------

def test_pump_death_fails_tickets_instead_of_hanging():
    """The pump dies at its first batch: the six tickets admitted before
    it fail typed, the tier refuses new work and the thread is gone -- in
    both packages, with the same texts.  The batch holds six rows and the
    flush timeout is never reached, so the pump flushes at the sixth
    submit, after every ticket is admitted."""
    def case(pkg_async, eng, errors, pkg_faults):
        srv = pkg_async(eng, max_wait_ms=1e7, max_queue=64)
        try:
            with pkg_faults.injected(pkg_faults.FaultPlan(
                    pump_death_at=(0,))):
                tickets = [srv.submit(X[i]) for i in range(6)]
                texts = []
                for t in tickets:
                    with pytest.raises(errors.EngineDegraded,
                                       match="pump thread died") as exc:
                        t.result(timeout=HUNG)
                    assert type(exc.value.__cause__).__name__ \
                        == "PumpFault"
                    texts.append(str(exc.value))
            assert all(t.done() for t in tickets)
            with pytest.raises(errors.EngineDegraded) as refused:
                srv.submit(X[0])
            assert srv.metrics.counter("failed") == 6
            assert not srv._pump.is_alive()
            return texts, str(refused.value)
        finally:
            srv.close(timeout=5.0)

    X = _grid(np.random.default_rng(6), 300, 16)
    got = case(AsyncEngine, Engine(bruteforce.build(X, device="cpu"), k=5,
                                   batch_size=6), port_errors, faults)
    want = case(JxAsync, JxEngine(jx_bf.build(X), k=5, batch_size=6),
                jx_errors, jx_faults)
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_pump_death_cause_is_preserved():
    rng = np.random.default_rng(7)
    X = _grid(rng, 300, 16)
    eng = Engine(bruteforce.build(X, device="cpu"), k=5, batch_size=8)
    srv = AsyncEngine(eng, max_wait_ms=1.0)
    try:
        with faults.injected(FaultPlan(pump_death_at=(0,))):
            t = srv.submit(X[0])
            with pytest.raises(EngineDegraded) as exc:
                t.result(timeout=HUNG)
        assert isinstance(exc.value.__cause__, PumpFault)
        assert str(exc.value).startswith("pump thread died: PumpFault: "
                                          "injected: pump thread crashed")
    finally:
        srv.close(timeout=5.0)


def test_pump_death_fails_the_batch_in_flight():
    """A ticket popped into the pump's batch when the loop dies (the
    ``_inflight`` batch, not the queue) fails too: the pump is held on an
    event inside its device call, and dies when the event lets it go."""
    class Crash(BaseException):
        """Escapes the batch's ``except Exception``, as a bug would."""

    class Dying(Engine):
        def _run_padded(self, Qb, n_live, overrides):
            assert hold.wait(HUNG)
            raise Crash("the loop itself failed")

    hold = threading.Event()
    rng = np.random.default_rng(8)
    X = _grid(rng, 100, 8)
    eng = Dying(bruteforce.build(X, device="cpu"), k=5, batch_size=8)
    srv = AsyncEngine(eng, max_wait_ms=1.0, max_queue=64)
    try:
        first = srv.submit(X[0])
        queued = [srv.submit(x) for x in X[1:3]]
        hold.set()
        for t in [first] + queued:
            with pytest.raises(EngineDegraded, match="Crash: the loop itself"):
                t.result(timeout=HUNG)
        assert srv.metrics.counter("failed") == 3
    finally:
        srv.close(timeout=5.0)


# --------------------------------------------------------------------------
# compaction through the pump (tests/test_faults.py)
# --------------------------------------------------------------------------

def test_async_compact_passthrough_counts_metrics():
    rng = np.random.default_rng(11)
    X, (jeng, eng) = _mutable_pair(rng, n=200, d=16, capacity=32)
    counts = []
    for pkg_async, e, pkg_faults, err in (
            (AsyncEngine, eng, faults, CompactionError),
            (JxAsync, jeng, jx_faults, jx_errors.CompactionError)):
        with pkg_async(e, max_wait_ms=1.0) as srv:
            handle = srv.compact(background=True)
            assert handle.join(timeout=HUNG).ok
            assert srv.metrics.counter("compactions") == 1
            e.insert(_grid(np.random.default_rng(1), 4, X.shape[1]),
                     auto_compact=False)
            with pkg_faults.injected(pkg_faults.FaultPlan(
                    compact_fault_at=(0,))):
                with pytest.raises(err, match="serving state untouched"):
                    srv.compact()
            counts.append(srv.metrics.snapshot()["counters"])
            assert srv.metrics.counter("compaction_failed") == 1
    assert counts[0] == counts[1]
    assert_same(eng.search(X[:6]), jeng.search(X[:6]))


def test_async_close_joins_inflight_background_compaction(monkeypatch):
    """close() racing a held background compact(): the rebuild waits
    until close() is joining the compactions, so close must drain the
    rebuild thread, and the compaction still lands."""
    rng = np.random.default_rng(12)
    X, (_, eng) = _mutable_pair(rng, n=200, d=16, capacity=32)
    real_build = delta._inner_build
    entered, joining = threading.Event(), threading.Event()

    def held_build(*a, **kw):
        entered.set()
        assert joining.wait(HUNG)          # until close() joins it
        return real_build(*a, **kw)

    real_join = eng.join_compactions

    def join(timeout=None):
        joining.set()
        return real_join(timeout)

    monkeypatch.setattr(delta, "_inner_build", held_build)
    monkeypatch.setattr(eng, "join_compactions", join)
    srv = AsyncEngine(eng, max_wait_ms=1.0)
    srv.submit(X[0]).result(timeout=HUNG)
    handle = srv.compact(background=True)
    assert entered.wait(HUNG), "rebuild never started"
    assert not handle.done()
    srv.close(timeout=60)                  # races the held rebuild
    assert handle.done(), "close() returned with the rebuild still running"
    assert handle.ok
    assert eng.stats["compactions"] == 1
    assert int(eng.state["count"]) == 0
    assert srv.metrics.counter("compactions") == 1


def test_insert_delete_passthrough_route_to_the_tenant():
    rng = np.random.default_rng(13)
    X, (jeng, eng) = _mutable_pair(rng, n=200, d=16, capacity=64)
    rows = _grid(np.random.default_rng(2), 3, X.shape[1])
    got = []
    for pkg_async, e in ((AsyncEngine, eng), (JxAsync, jeng)):
        with pkg_async({"m": e}, max_wait_ms=1.0) as srv:
            ids = srv.insert(rows, tenant="m", auto_compact=False)
            srv.delete(ids[:1], tenant="m")
            got.append((np.asarray(ids), srv.search(X[:5], tenant="m")))
    np.testing.assert_array_equal(got[0][0], got[1][0])
    assert_same(got[0][1], got[1][1])
    assert eng.stats["inserts"] == jeng.stats["inserts"]
    assert isinstance(ServeError("x"), RuntimeError)
    assert issubclass(RetriesExhausted, ServeError)
    assert issubclass(DeadlineExceeded, TimeoutError)
