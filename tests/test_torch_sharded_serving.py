"""Sharded serving in the port (``repro_torch.serve`` over a ``Sharded*``
state) against the JAX package's: the sharded cases of
``tests/test_faults.py`` -- degraded coverage, ``Ticket.coverage`` /
``.partial``, a direct sharded search noting its degradation, and real
``ShardFault``s from a seeded fault plan retried (then served, exhausted,
or given up against a deadline).

Both packages serve a 1-shard ShardedBruteForce over the same
small-integer grid rows (every euclidean distance exact), get the same
requests under the same plan, and must answer alike: ids and distances
bitwise, the same coverages, counters and error types.  The reference's
zero-retrace check becomes the port's padded-shape identity (``batches *
batch_size == queries + padded``): the port has no trace.  An 8-shard
engine then holds the degraded answers to the survivors' rows.

No test sleeps or waits on the clock (``result(timeout=30)`` only guards
against a hang).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.ann  # noqa: E402,F401
from repro.serve import AsyncEngine as JxAsync  # noqa: E402
from repro.serve import Engine as JxEngine  # noqa: E402
from repro.serve import errors as jx_errors  # noqa: E402
from repro.serve import faults as jx_faults  # noqa: E402
from repro.serve import retry as jx_retry  # noqa: E402
from repro_torch.ann import bruteforce, sharded  # noqa: E402
from repro_torch.dist.mesh import force_device_count  # noqa: E402
from repro_torch.serve import (AsyncEngine, Engine, FaultPlan,  # noqa: E402
                               RetriesExhausted, RetryPolicy, ShardFault,
                               errors, faults, retry)

HUNG = 30           # seconds: a guard against a hang, never a wait
PKGS = {"port": (Engine, AsyncEngine, faults, errors, retry),
        "reference": (JxEngine, JxAsync, jx_faults, jx_errors, jx_retry)}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    for pkg in (faults, jx_faults):
        pkg.clear()
        pkg.clear_degraded()
    yield
    faults.clear()
    jx_faults.clear()


def _sharded_engine(which, seed, n=300, d=16, **kw):
    """tests/test_faults.py's ``_sharded_engine`` in package ``which``, on
    grid rows."""
    rng = np.random.default_rng(seed)
    X = rng.integers(-8, 8, size=(n, d)).astype(np.float32)
    kw.setdefault("k", 5)
    kw.setdefault("batch_size", 8)
    eng_cls = PKGS[which][0]
    extra = {"device": "cpu"} if which == "port" else {}
    return X, eng_cls.build("ShardedBruteForce", X, metric="euclidean",
                            build_params={"n_shards": 1}, **extra, **kw)


def _both(case, seed):
    """``case(which, X, engine, pkg)`` in each package: (port, reference)."""
    out = []
    for which in ("port", "reference"):
        X, eng = _sharded_engine(which, seed)
        out.append(case(which, X, eng, PKGS[which]))
    return out


def assert_same(got, want):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


# ------------------------------------------------------- degraded serving

def test_engine_degraded_coverage_and_zero_retrace():
    def case(which, X, eng, pkg):
        plan_cls = pkg[2].FaultPlan
        d0, i0 = eng.search(X[:4])
        before = dict(eng.stats)
        with pkg[2].injected(plan_cls(shard_drop_at=((0, 0),))):
            d1, i1 = eng.search(X[:4])
        assert eng.last_coverage == 0.0
        assert np.all(np.asarray(i1) == -1)
        assert eng.stats["degraded"] == 4
        d2, i2 = eng.search(X[:4])
        assert eng.last_coverage == 1.0
        assert_same((d2, i2), (d0, i0))
        # every call, the degraded one included, ran at the one padded
        # shape (the reference's single trace)
        calls = {k: eng.stats[k] - before[k]
                 for k in ("batches", "queries", "padded")}
        assert calls["batches"] * eng.batch_size \
            == calls["queries"] + calls["padded"] == 16
        return (d0, i0), (d1, i1)

    (got0, got1), (want0, want1) = _both(case, 0)
    assert_same(got0, want0)
    assert_same(got1, want1)


def test_ticket_carries_coverage_and_partial():
    def case(which, X, eng, pkg):
        eng.search(X[:1])
        with pkg[1](eng, max_wait_ms=1.0) as srv:
            full = srv.submit(X[0])
            fd = full.result(timeout=HUNG)
            assert full.coverage == 1.0 and not full.partial
            with pkg[2].injected(pkg[2].FaultPlan(shard_drop_at=((0, 0),))):
                part = srv.submit(X[1])
                d, ids = part.result(timeout=HUNG)     # degraded, NOT failed
            assert part.coverage == 0.0 and part.partial
            assert np.all(ids == -1)
            m = srv.metrics
            assert m.counter("degraded") == 1
            assert m.coverage_percentile(5) < 1.0
            snap = m.snapshot()
            assert snap["coverage"]["count"] == 2
            assert snap["counters"]["served"] == 2
            return fd, (d, ids), snap["coverage"]

    (fd, part, cov), (jfd, jpart, jcov) = _both(case, 1)
    assert_same(fd, jfd)
    assert_same(part, jpart)
    assert cov == jcov


def test_direct_sharded_search_notes_degradation():
    from repro.ann import sharded as jx_sh

    rng = np.random.default_rng(2)
    X = rng.standard_normal((200, 16)).astype(np.float32)
    st = sharded.bruteforce_build(X, metric="euclidean", n_shards=1,
                                  device="cpu")
    with faults.injected(FaultPlan(shard_drop_at=((0, 0),))):
        _, ids = sharded.bruteforce_search(st, X[:2], k=3)
    assert np.all(ids.numpy() == -1)
    jst = jx_sh.bruteforce_build(X, metric="euclidean", n_shards=1)
    with jx_faults.injected(jx_faults.FaultPlan(shard_drop_at=((0, 0),))):
        jx_sh.bruteforce_search(jst, X[:2], k=3)
    assert faults.last_degraded() == jx_faults.last_degraded() == (0.0, (0,))
    # a caller's own mask (fault_hook off) is noted nowhere
    faults.clear_degraded()
    _, ids = sharded.bruteforce_search(st, X[:2], k=3, shard_ok=[False],
                                       fault_hook=False)
    assert np.all(ids.numpy() == -1) and faults.last_degraded() is None


# ------------------------------------------------------------------ retries

def test_transient_shard_fault_retries_then_succeeds():
    def case(which, X, eng, pkg):
        eng.search(X[:1])
        pol = pkg[4].RetryPolicy(max_attempts=3, base_ms=0.1, jitter=0.0)
        with pkg[1](eng, max_wait_ms=1.0, retry=pol) as srv:
            with pkg[2].injected(pkg[2].FaultPlan(shard_raise_at=(0,))):
                t = srv.submit(X[0])
                got = t.result(timeout=HUNG)        # attempt 2 succeeds
            assert np.all(got[1] >= 0)
            return got, {c: srv.metrics.counter(c)
                         for c in ("retried", "served", "failed")}

    (got, counts), (want, jcounts) = _both(case, 3)
    assert_same(got, want)
    assert counts == jcounts == {"retried": 1, "served": 1, "failed": 0}


def test_retries_exhausted_is_typed_and_counted():
    def case(which, X, eng, pkg):
        eng.search(X[:1])
        errs = pkg[3]
        pol = pkg[4].RetryPolicy(max_attempts=2, base_ms=0.1, jitter=0.0)
        with pkg[1](eng, max_wait_ms=1.0, retry=pol) as srv:
            with pkg[2].injected(pkg[2].FaultPlan(shard_raise=1.0)):
                t = srv.submit(X[0])
                with pytest.raises(errs.RetriesExhausted) as exc:
                    t.result(timeout=HUNG)
            assert isinstance(exc.value.__cause__, errs.ShardFault)
            counts = {c: srv.metrics.counter(c)
                      for c in ("failed", "retried")}
            # the pump survived: a later fault-free request is served
            d, ids = srv.submit(X[1]).result(timeout=HUNG)
            assert np.all(ids >= 0)
            return str(exc.value), counts, (d, ids)

    (msg, counts, got), (jmsg, jcounts, want) = _both(case, 4)
    assert counts == jcounts == {"failed": 1, "retried": 1}
    assert msg == jmsg
    assert_same(got, want)


def test_deadline_aware_retry_budget_gives_up_early():
    def case(which, X, eng, pkg):
        eng.search(X[:1])
        # a huge backoff against a tiny deadline: the first failure must
        # surface as RetriesExhausted at once instead of sleeping past it
        pol = pkg[4].RetryPolicy(max_attempts=5, base_ms=10_000.0,
                                 max_ms=10_000.0, jitter=0.0)
        with pkg[1](eng, max_wait_ms=1.0, retry=pol) as srv:
            with pkg[2].injected(pkg[2].FaultPlan(shard_raise_at=(0,))):
                t = srv.submit(X[0], deadline_ms=200.0)
                t0 = time.perf_counter()
                with pytest.raises(pkg[3].RetriesExhausted,
                                   match="no live deadline"):
                    t.result(timeout=HUNG)
                assert time.perf_counter() - t0 < 5.0
            return srv.metrics.counter("retried")

    assert _both(case, 5) == [0, 0]


# --------------------------------------------------- 8 shards, real masks

def test_eight_shard_degraded_answers_equal_the_survivors():
    """An 8-shard engine under a seeded drop plan: each degraded
    micro-batch's coverage is its survivors' share of the rows, and its
    answers equal a search over only those rows."""
    prev = force_device_count(8)
    try:
        rng = np.random.default_rng(6)
        X = rng.integers(-8, 8, size=(403, 12)).astype(np.float32)
        Q = rng.integers(-8, 8, size=(48, 12)).astype(np.float32)
        eng = Engine.build("ShardedBruteForce", X, metric="euclidean",
                           build_params={"n_shards": 8}, device="cpu",
                           k=6, batch_size=8)
        owners = eng.state["ids"].numpy()
        plan = FaultPlan(seed=3, shard_drop=0.3)
        degraded = 0
        with faults.injected(plan):
            for s in range(0, len(Q), 8):
                e = plan.events("shard_drop")
                d, ids = eng.search(Q[s:s + 8])
                keep = np.array([not ((e, sh) in plan.shard_drop_at or
                                      plan._hit("shard_drop", e,
                                                plan.shard_drop,
                                                extra=sh + 1))
                                 for sh in range(8)])
                rows = np.sort(owners[keep][owners[keep] >= 0])
                assert eng.last_coverage == pytest.approx(
                    rows.size / X.shape[0])
                degraded += int(not keep.all())
                want = bruteforce.search(
                    bruteforce.build(X[rows], metric="euclidean",
                                     device="cpu"), Q[s:s + 8], k=6)
                want_ids = np.where(want[1].numpy() >= 0,
                                    rows[np.maximum(want[1].numpy(), 0)],
                                    -1)
                np.testing.assert_array_equal(ids, want_ids)
                np.testing.assert_array_equal(d, want[0].numpy())
        assert degraded >= 3 and eng.stats["degraded"] == 8 * degraded
    finally:
        force_device_count(prev)


def test_retried_shard_fault_is_served_on_eight_shards():
    prev = force_device_count(8)
    try:
        rng = np.random.default_rng(7)
        X = rng.integers(-8, 8, size=(200, 12)).astype(np.float32)
        eng = Engine.build("ShardedBruteForce", X, metric="euclidean",
                           build_params={"n_shards": 8}, device="cpu",
                           k=5, batch_size=8)
        want = eng.search(X[:1])
        pol = RetryPolicy(max_attempts=3, base_ms=0.1, jitter=0.0)
        with AsyncEngine(eng, max_wait_ms=1.0, retry=pol) as srv:
            with faults.injected(FaultPlan(shard_raise_at=(0,))):
                got = srv.submit(X[0]).result(timeout=HUNG)
            assert srv.metrics.counter("retried") == 1
        np.testing.assert_array_equal(got[1], want[1][0])
        with pytest.raises(ShardFault):
            with faults.injected(FaultPlan(shard_raise=1.0)):
                eng.search(X[:1])
        assert RetriesExhausted is errors.RetriesExhausted
    finally:
        force_device_count(prev)
