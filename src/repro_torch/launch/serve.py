"""ANN serving launcher (``repro.launch.serve``): build a functional index
over a dataset and serve it through the serving tier, reporting the
paper's metrics (recall vs QPS) plus the serving tier's own (p50/p95/p99
latency, timeouts, rejections).

Three modes:

  * ``--mode batch`` (default) -- the closed-loop micro-batch path: fixed
    request batches through ``Engine.search``, live recall/QPS per batch.
  * ``--mode stream`` -- the open-loop SLO path: Poisson arrivals
    submitted to the :class:`~repro_torch.serve.AsyncEngine` background
    pump (timeout flush, per-request deadlines, bounded-queue admission
    control), with latency percentiles from the serving histogram.
  * ``--mode churn`` -- interleaved streaming mutation: each iteration
    inserts ``--churn-inserts`` rows, tombstones the batch from two
    iterations back, and serves a query batch, with recall scored against
    an exact oracle over the live corpus.  Needs a mutable algorithm
    (``--algorithm MutableIVF`` / ``MutableBruteForce``).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --dataset blobs-euclidean-20000 --algorithm IVF \\
        --build n_clusters=64 --query n_probes=8 --mode stream \\
        --max-wait-ms 5 --deadline-ms 100 --n-requests 2000 [--device cpu]

The index lives on ``--device`` (``cuda`` unless told otherwise).  Knob
strings (``--build``/``--query``) parse through the shared
:mod:`repro_torch.launch.knobs` helper -- ``--query ef=64,n_probes=8``
and ``--query ef=64 n_probes=8`` are equivalent, and errors match
``repro_torch.launch.tune`` exactly.  Recall is routed through
``core.metrics.recall_from_arrays`` -- the exact definition the benchmark
results layer uses -- so serve-time and benchmark-time recall cannot
drift.  ``--index-cache`` reads and writes the reference's checkpoint
format, so either package's file serves here.

Legacy positional ``--args``/``--query-args`` are still accepted and mapped
through the functional spec's parameter names.  ``--shards N`` serves the
sharded variant (BruteForce -> ShardedBruteForce, IVF -> ShardedIVF) over
N logical devices stacked on the one ``--device``
(:mod:`repro_torch.dist.mesh`: set the count with the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=N``).  ``--faults``
installs a seeded fault plan for the stream: dropped shards give degraded
answers (``coverage < 1``), which the stream mode counts apart and leaves
out of its recall.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.ann import distances as D
from repro_torch.ann.functional import get_functional
from repro_torch.core.metrics import recall_from_arrays
from repro_torch.data import get_dataset
from repro_torch.launch.knobs import coerce, parse_build, parse_kv
from repro_torch.serve import (AdmissionError, AsyncEngine, CheckpointError,
                               DeadlineExceeded, Engine, FaultPlan,
                               RetryPolicy, ServeError, faults)

# the reference's older import surface (``launch.tune`` used to pull
# these from ``launch.serve``); the canonical home is launch.knobs.
_coerce = coerce
_kv = parse_kv


def apply_shards(args) -> None:
    """``--shards N``: serve the sharded variant of the algorithm over N
    logical devices (BruteForce -> ShardedBruteForce, IVF -> ShardedIVF;
    already-sharded algorithms just get ``n_shards`` pinned)."""
    if args.shards is None:
        return
    from repro_torch.dist import shard_state as SS
    from repro_torch.dist.mesh import device_count

    n = int(args.shards)
    if n > device_count():
        raise SystemExit(
            f"[serve] --shards {n} needs {n} devices but only "
            f"{device_count()} are visible; set XLA_FLAGS="
            f"--xla_force_host_platform_device_count={n} to simulate")
    plan = SS.SHARD_PLANS.get(args.algorithm)
    if plan is not None:
        args.algorithm = plan.sharded_algo
    elif args.algorithm not in SS.sharded_algos():
        raise SystemExit(
            f"[serve] --shards: no sharded variant of {args.algorithm} "
            f"(shardable: {sorted(SS.SHARD_PLANS)}, "
            f"sharded: {list(SS.sharded_algos())})")
    args.build = list(args.build) + [f"n_shards={n}"]


def build_or_restore(args, ds, device) -> Engine:
    spec = get_functional(args.algorithm)
    if args.index_cache:
        try:
            eng = Engine.load(args.index_cache, device=device, k=args.count,
                              batch_size=args.batch_size)
            if eng.state.algo != spec.name:
                raise CheckpointError(
                    f"cache holds {eng.state.algo}, requested {spec.name}")
            print(f"[serve] restored {eng.state.algo} index from "
                  f"{args.index_cache} ({eng.index_size_kb():.0f} kB)")
            return eng
        except CheckpointError as e:
            print(f"[serve] cache miss ({e}); building")
    build_params = parse_build(args.build)
    # legacy positional --args map onto nothing structured; accept the old
    # IVF/LSH convention of a single leading int = first build knob
    for value, name in zip([coerce(a) for a in args.args],
                           _positional_build_names(spec)):
        build_params.setdefault(name, value)
    t0 = time.perf_counter()
    eng = Engine.build(spec.name, ds.train, metric=ds.metric,
                       build_params=build_params, device=device,
                       k=args.count, batch_size=args.batch_size)
    print(f"[serve] built {spec.name} index in "
          f"{time.perf_counter() - t0:.2f}s ({eng.index_size_kb():.0f} kB)")
    if args.index_cache:
        eng.save(args.index_cache)
        print(f"[serve] checkpointed to {args.index_cache}")
    return eng


def _positional_build_names(spec):
    """Build-knob order for the legacy positional --args form."""
    import inspect

    sig = inspect.signature(spec.build)
    return [name for name, p in sig.parameters.items()
            if p.kind == p.KEYWORD_ONLY and name not in ("metric", "device")]


def _recall_rows(ds, Q, ids, sel, k, device):
    """Shared-definition recall for served answers (paper §3.6)."""
    dists = D.pairwise_rows(Q, ds.train, ids[:, :k], ds.metric,
                            device=device)
    return recall_from_arrays(dists, ds.distances[sel], k,
                              neighbors=ids[:, :k])


def batch_loop(eng: Engine, ds, args) -> float:
    rng = np.random.default_rng(0)
    k = args.count
    total_q, total_t, recalls = 0, 0.0, []
    for b in range(args.n_batches):
        idx = rng.integers(0, len(ds.test), args.batch_size)
        Q = ds.test[idx]
        t0 = time.perf_counter()
        _, ids = eng.search(Q)
        dt = time.perf_counter() - t0
        rec = float(np.mean(_recall_rows(ds, Q, ids, idx, k,
                                         args.device)))
        recalls.append(rec)
        total_q += len(Q)
        total_t += dt
        print(f"  batch {b}: {len(Q) / dt:9.0f} QPS  recall@{k} "
              f"= {rec:.3f}")
    agg = float(np.mean(recalls))
    print(f"[serve] aggregate {total_q / total_t:.0f} QPS over "
          f"{total_q} queries, mean recall@{k} = {agg:.3f}")
    return agg


def churn_loop(eng: Engine, ds, args) -> float:
    """Interleaved insert/delete/search against a mutable index.

    Each iteration inserts ``--churn-inserts`` rows (fresh ids), tombstones
    the batch inserted two iterations earlier (net live size ~constant once
    warm), then serves a query batch.  Recall is scored against an exact
    oracle over the CURRENT live corpus (a BruteForce index of the live
    rows on the same device) -- the dataset's precomputed ground truth goes
    stale the moment the corpus mutates.  Compaction happens through the
    Engine's own threshold policy; the count is reported.
    """
    from repro_torch import mutate
    from repro_torch.ann import bruteforce

    if not mutate.is_mutable(eng.state):
        raise SystemExit(
            f"[serve] --mode churn needs a mutable algorithm "
            f"(--algorithm MutableIVF or MutableBruteForce); "
            f"{eng.state.algo} is frozen")
    rng = np.random.default_rng(0)
    k = args.count
    pending, recalls = [], []
    total_q, total_t = 0, 0.0
    for b in range(args.n_batches):
        rows = ds.train[rng.integers(0, len(ds.train), args.churn_inserts)]
        pending.append(np.asarray(eng.insert(rows)))
        if len(pending) > 2:
            eng.delete(pending.pop(0))
        idx = rng.integers(0, len(ds.test), args.batch_size)
        Q = ds.test[idx]
        t0 = time.perf_counter()
        _, ids = eng.search(Q)
        dt = time.perf_counter() - t0
        gids, X_live = mutate.live_items(eng.state)
        st = bruteforce.build(X_live, metric=ds.metric, device=args.device)
        _, orc = bruteforce.search(st, Q, k=k)
        true = gids[orc.cpu().numpy()]
        hits = sum(len(set(p.tolist()) & set(t.tolist()))
                   for p, t in zip(ids[:, :k], true))
        rec = hits / (len(Q) * k)
        recalls.append(rec)
        total_q += len(Q)
        total_t += dt
        print(f"  churn {b}: {len(Q) / dt:9.0f} QPS  recall@{k} = "
              f"{rec:.3f}  live={mutate.live_count(eng.state)}  "
              f"delta={mutate.delta_fraction(eng.state):.2f}")
    agg = float(np.mean(recalls))
    print(f"[serve] aggregate {total_q / total_t:.0f} QPS over "
          f"{total_q} queries, mean recall@{k} = {agg:.3f}; "
          f"inserts={eng.stats['inserts']} deletes={eng.stats['deletes']} "
          f"compactions={eng.stats['compactions']}")
    return agg


def stream_loop(eng: Engine, ds, args) -> float:
    """Open-loop Poisson arrivals through the AsyncEngine pump.

    ``--faults`` installs a seeded :class:`FaultPlan` for the duration of
    the stream (chaos mode: transient retries, pump death);
    ``--retry`` tunes the pump's :class:`RetryPolicy`."""
    k = args.count
    rng = np.random.default_rng(0)
    rate = args.rate
    if rate is None:
        # probe closed-loop capacity (warm: the first call pays one-time
        # costs that are not per request), then offer sub-capacity
        eng.search(ds.test[:eng.batch_size])
        t0 = time.perf_counter()
        eng.search(ds.test[:eng.batch_size])
        svc = time.perf_counter() - t0
        rate = 0.5 * eng.batch_size / max(svc, 1e-6)
    plan = FaultPlan.from_spec(args.faults) if args.faults else None
    retry = RetryPolicy.from_spec(args.retry) if args.retry else None
    print(f"[serve] stream: {args.n_requests} requests, Poisson "
          f"{rate:.0f}/s, max_wait={args.max_wait_ms} ms, "
          f"deadline={args.deadline_ms} ms, max_queue={args.max_queue}"
          + (f", faults={plan.describe()}" if plan else ""))
    srv = AsyncEngine(eng, max_wait_ms=args.max_wait_ms,
                      max_queue=args.max_queue,
                      default_deadline_ms=args.deadline_ms,
                      retry=retry)
    gaps = rng.exponential(1.0 / rate, args.n_requests)
    sels = rng.integers(0, len(ds.test), args.n_requests)
    if plan is not None:
        faults.install(plan)
    try:
        inflight, rejected = [], 0
        for sel, gap in zip(sels, gaps):
            try:
                inflight.append((srv.submit(ds.test[sel]), int(sel)))
            except AdmissionError:
                rejected += 1
            time.sleep(gap)
        answered_ids, answered_sel = [], []
        timed_out = failed = degraded = 0
        for ticket, sel in inflight:
            try:
                _, ids = ticket.result(timeout=60)
            except DeadlineExceeded:
                timed_out += 1
                continue
            except ServeError as e:
                failed += 1            # e.g. RetriesExhausted under chaos
                print(f"[serve] request failed: {type(e).__name__}: {e}")
                continue
            if ticket.partial:
                degraded += 1
                continue               # partial answers skew recall; report
            answered_ids.append(ids)
            answered_sel.append(sel)
    finally:
        if plan is not None:
            faults.clear()
    srv.close()
    agg = float("nan")
    if answered_ids:
        ids = np.stack(answered_ids)
        sel = np.asarray(answered_sel)
        agg = float(np.mean(_recall_rows(ds, ds.test[sel], ids, sel, k,
                                         args.device)))
    snap = srv.metrics.snapshot()
    lat = snap["latency_ms"]
    print(f"[serve] answered {len(answered_ids)}/{args.n_requests} "
          f"(timed out {timed_out}, rejected {rejected}, failed {failed}, "
          f"degraded {degraded}) in "
          f"{srv.metrics.counter('batches')} micro-batches; "
          f"mean full-coverage recall@{k} = {agg:.3f}")
    if degraded or failed:
        cov = snap["coverage"]
        print(f"[serve] chaos: retried={srv.metrics.counter('retried')} "
              f"coverage p5={cov['p5']:.3f} p50={cov['p50']:.3f} "
              f"min={cov['min']:.3f}")
    print(f"[serve] latency ms: p50={lat['p50']:.2f} p95={lat['p95']:.2f} "
          f"p99={lat['p99']:.2f} max={lat['max']:.2f}")
    return agg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="blobs-euclidean-20000")
    p.add_argument("--algorithm", default="IVF")
    p.add_argument("--mode", default="batch",
                   choices=["batch", "stream", "churn"],
                   help="closed-loop micro-batches, open-loop async pump, "
                        "or interleaved mutation (needs a Mutable* "
                        "algorithm)")
    p.add_argument("--args", nargs="*", default=[],
                   help="legacy positional build args")
    p.add_argument("--query-args", nargs="*", default=[],
                   help="legacy positional query args")
    p.add_argument("--build", nargs="*", default=[],
                   help="build params as key=value (comma-separable)")
    p.add_argument("--query", nargs="*", default=[],
                   help="query params as key=value (comma-separable)")
    p.add_argument("--shards", type=int, default=None,
                   help="serve the sharded variant of --algorithm over N "
                        "logical devices on --device (BruteForce -> "
                        "ShardedBruteForce, IVF -> ShardedIVF)")
    p.add_argument("--count", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--n-batches", type=int, default=8)
    p.add_argument("--index-cache", default=None)
    p.add_argument("--assert-recall", type=float, default=None,
                   help="exit non-zero unless aggregate recall >= this")
    # stream-mode pump knobs
    p.add_argument("--n-requests", type=int, default=2000)
    p.add_argument("--rate", type=float, default=None,
                   help="Poisson arrivals/s (default: 0.5x probed capacity)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="pump flush timeout (latency/batching trade-off)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request deadline; late answers time out")
    p.add_argument("--max-queue", type=int, default=1024,
                   help="admission bound: reject beyond this queue depth")
    p.add_argument("--faults", default=None,
                   help="chaos mode: seeded fault plan for the stream, "
                        "e.g. 'seed=7,shard_drop=0.1,shard_raise=0.05' "
                        "(see repro_torch.serve.faults.FaultPlan.from_spec)")
    p.add_argument("--retry", default=None,
                   help="retry policy for transient faults, e.g. "
                        "'attempts=4,base_ms=2,jitter=0.5' "
                        "(see repro_torch.serve.retry.RetryPolicy.from_spec)")
    # churn-mode knobs
    p.add_argument("--churn-inserts", type=int, default=32,
                   help="rows inserted (and later deleted) per iteration "
                        "in --mode churn")
    p.add_argument("--device", default="cuda",
                   help="where the index lives and the queries run")
    args = p.parse_args(argv)

    apply_shards(args)
    args.device = resolve_device(args.device)
    ds = get_dataset(args.dataset, device=args.device)
    eng = build_or_restore(args, ds, args.device)

    spec = eng.spec
    # explicit --query key=value wins over legacy positional --query-args,
    # matching the --build vs --args precedence on the build side
    qparams = parse_kv(args.query)
    for name, value in zip(spec.query_params,
                           [coerce(a) for a in args.query_args]):
        qparams.setdefault(name, value)
    eng.query_params.update(qparams)

    loop = {"batch": batch_loop, "stream": stream_loop,
            "churn": churn_loop}[args.mode]
    agg = loop(eng, ds, args)
    if args.assert_recall is not None and \
            not agg >= args.assert_recall:
        raise SystemExit(
            f"[serve] recall {agg:.3f} < required {args.assert_recall}")
    return agg


if __name__ == "__main__":
    main()
